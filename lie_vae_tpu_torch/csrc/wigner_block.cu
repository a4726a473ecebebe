// The block-Wigner product out = W(angles) @ spec synthesised from the
// Fourier coefficients of its middle factor, forward and backward, for one
// NVIDIA Hopper card (sm_90a).
//
// Replaces the TPU kernels lie_vae_tpu/ops/kernels/wigner_block.py::
// _wigner_apply_kernel (:54, forward: wigner_block_fwd, K5) and
// ::_wigner_bwd_kernel (:85, backward: wigner_block_bwd, K6), run through
// _make_op (:153-223). Those take trig features precomputed by XLA, keep
// four dense (2L+1, S, S) coefficient tensors C, C[rev,:], C[:,rev],
// C[rev,rev] resident in VMEM, synthesise four dense (S, S) factors per
// sample and take one (S, S) x (S, C) MXU product; the batch is padded to
// the block size. The function carries over:
//
//   angles (B, 3) float32, ZYZ (a, b, g); spec shared (S, C), read in place
//   at stride 0, or per sample (B, S, C); out (B, S, C) float32,
//   S = (L+1)^2, any 0 <= L <= 16, any C >= 1, any B >= 1.
//   d(b) = sum_m t_m(b) C_m, t = [cos 0b .. cos Lb, sin 1b .. sin Lb];
//   W = Z(a) d(b) Z(g), (Z(t) h)_i = cos(f_i t) h_i + sin(f_i t) h_rev(i),
//   f_i = l - (i - l^2) for row i in degree block l, rev the reversal
//   inside each block; out = W spec, or W^T spec with `transpose`.
//
// The TPU kernel's W[s, e] = cg_e (ca_s d[s, e] + sa_s d[rev s, e])
// - sg_e (ca_s d[s, rev e] + sa_s d[rev s, rev e]) is this factorisation:
// u = Z(g) x, w = d u, out = Z(a) w, so W is never formed. The cosine
// slots of C are symmetric and the sine slots antisymmetric (tested), so
// d(b)^T = d(-b) and W^T = W(-g, -b, -a): `transpose` runs the same
// product at those angles, and maps their gradient back.
//
// Design: one thread per column. W is block-diagonal by degree, so a
// column (sample b, degree l, channel c), the n = 2l+1 rows of degree l,
// goes through Z(g), d and Z(a) on its own; one thread keeps its n values
// in registers through every step (n a template parameter, loops
// unrolled). The thread forms its sample's trig itself (full-precision
// sincosf of m times each angle, m <= l, staged once per block in shared
// memory). d u is sum_m t_m (C_m u) over the coefficients that can be
// non-zero, read as compile-time offsets into a table:
//
// Which coefficients can be non-zero. C_m = sum over c with |f_c| = m of
// J[:, c] J[c, :] (cosine slot) or -sign(f_c) J[:, rev c] J[c, :] (sine
// slot), and J_l couples row i to column k only within classes of rows:
// group g = 2 (f <= 0) + (|f| odd) of a row, J_l couples g to itself or to
// g ^ 3 (partner below; the twin of wigner_chain's J rule, tested against
// it). So each slot has at most two dense blocks, rows of one group times
// columns of another: 597 coefficients for L = 6 instead of the 4753 of
// the degree blocks (below 1.3e-15 everywhere else, tested for L <= 16).
// The table lists them slot by slot (cos 0..l, sin 1..l), block by block,
// row-major in each block; degrees 0..14 (12489 floats, 49 KB) sit in
// constant memory as FMA operands, degrees 15-16 (8128 floats) in global
// memory read through the read-only cache, since constant memory holds
// 64 KB. Both are loaded once per device (wigner_block_load_coeffs).
//
// Launch plan. blockIdx.y is the degree, heaviest first (l = L - y), so
// every warp works on one l (uniform table reads, no divergence).
// blockIdx.x takes nb samples times a tile of ct channels (nb * ct <= 128
// threads, c fastest; C above 128 is cut into equal tiles). One kernel is
// built per cap on the degree (3, 6, 10, 16), a launch taking the smallest
// cap >= L: its registers follow the cap's largest column.
//
// Backward, for a cotangent G of out (Omega h)_i = f_i h_rev(i) the
// generator, Z(t) = exp(t Omega), Z(t)^T = Z(-t):
//   gw = Z(-a) G, u = Z(g) x; per slot y = C_m u, w += t_m y,
//   dt_m = <gw, y>, du += t_m C_m^T gw (one pass over the table);
//   da = <gw, Omega w>, db = sum_m dt_m t_m'(b), dg = <du, Omega u>,
//   dx = Z(-g) du,
// each column adding its own terms in registers: the chain rule through
// cos/sin(f a), t(b) and cos/sin(f g) happens here, not in autograd. A
// block sums its threads' terms per sample in channel order (shared
// memory) into scratch[(L - l) * ctiles + tile][b]; a second small kernel
// adds the (L+1) * ctiles slots of each sample in slot order. No atomics:
// a run repeats bit for bit. dx is per sample; for a shared spectrum the
// caller sums it over the batch.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32): the
// bytes. Per sample at L = 6, C = 10, K5 writes 4 S C = 1960 B and reads
// 12 B of angles; K6 reads dout and writes dx (3920 B), with the spectrum
// and the 2388 B of coefficients once per call. The float32 work is about
// 2 * 597 C FMAs a sample forward and twice that backward, 0.6 operations
// per byte forward: far below the card's 20 outside the tensor cores.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxDegree = 16;        // the degrees ops/jd_tables.npz holds
constexpr int kConstDegree = 14;      // degrees whose coefficients are constant
// Degrees above kUnrollDegree run their coefficient loops rolled (their
// columns then live in local memory): fully unrolled, the kernels of
// degrees 11-16 took 130 s of a 150 s build with the H100 machine's nvcc.
constexpr int kUnrollDegree = 10;
constexpr int kThreads = 128;         // threads a block at most
constexpr size_t kSmemLimit = 48 * 1024;

// Row groups of degree l: g = 2 (f <= 0) + (|f| odd), f = l - p the
// frequency of local row p. A group's rows are spaced by 2.
__host__ __device__ constexpr int grp_size(int l, int g) {
  return g >= 2 ? ((g & 1) ? (l + 1) / 2 : l / 2 + 1)
                : ((g & 1) ? (l + 1) / 2 : l / 2);
}

// local row of the group's first member (members ascend by 2)
__host__ __device__ constexpr int grp_first(int l, int g) {
  return g >= 2 ? l + (g & 1) : (l + (g & 1)) % 2;
}

// The group J_l couples g to: itself where (f > 0) == (|f| odd) differs
// from l's parity, else the group of the other sign and parity.
__host__ __device__ constexpr int partner(int l, int g) {
  return ((g < 2) == ((g & 1) == 1)) != ((l & 1) == 1) ? g : g ^ 3;
}

// slot s of degree l: cos(m b) for s <= l (m = s), sin(m b) after (m = s - l)
__host__ __device__ constexpr int slot_m(int l, int s) {
  return s <= l ? s : s - l;
}

// Block b of slot s: rows and columns, each a group. Slot 0 has one block
// (c = l, f_c = 0); slot m > 0 two, from c of f_c = +m (group m & 1) and
// of f_c = -m (group 2 + (m & 1)): cos C_m rows and columns both partner
// of that c's group, sin C_m rows partner of rev c's and columns of c's.
__host__ __device__ constexpr int blk_rows(int l, int s, int b) {
  const int m = slot_m(l, s);
  if (m == 0) return partner(l, 2);
  return partner(l, ((b == 0) == (s <= l)) ? (m & 1) : 2 + (m & 1));
}

__host__ __device__ constexpr int blk_cols(int l, int s, int b) {
  const int m = slot_m(l, s);
  if (m == 0) return partner(l, 2);
  return partner(l, b == 0 ? (m & 1) : 2 + (m & 1));
}

__host__ __device__ constexpr int blk_size(int l, int s, int b) {
  return grp_size(l, blk_rows(l, s, b)) * grp_size(l, blk_cols(l, s, b));
}

__host__ __device__ constexpr int slot_size(int l, int s) {
  return blk_size(l, s, 0) + (slot_m(l, s) > 0 ? blk_size(l, s, 1) : 0);
}

// first table entry of degree l
__host__ __device__ constexpr int coef_offset(int l) {
  int k = 0;
  for (int d = 0; d < l; ++d)
    for (int s = 0; s <= 2 * d; ++s) k += slot_size(d, s);
  return k;
}

// first table entry of block b of slot s of degree l
__host__ __device__ constexpr int blk_offset(int l, int s, int b) {
  int k = coef_offset(l);
  for (int r = 0; r < s; ++r) k += slot_size(l, r);
  return k + (b > 0 ? blk_size(l, s, 0) : 0);
}

constexpr int kCoefs = coef_offset(kMaxDegree + 1);        // 20617
constexpr int kConstCoefs = coef_offset(kConstDegree + 1);  // 12489
static_assert(kConstCoefs * sizeof(float) <= 60 * 1024,
              "the constant part of the table must fit constant memory");

__constant__ float kC[kConstCoefs];
__device__ float kCHigh[kCoefs - kConstCoefs];

// table entry k of degree l: a constant-bank operand, or a read-only load
template <int l>
__device__ __forceinline__ float coef(int k) {
  if constexpr (l <= kConstDegree) {
    return kC[k];
  } else {
    return __ldg(kCHigh + (k - kConstCoefs));
  }
}

template <int l>
using Col = float[2 * l + 1];

template <int l>
__device__ __forceinline__ void load_col(Col<l>& v, const float* p, int C) {
#pragma unroll
  for (int k = 0; k < 2 * l + 1; ++k) v[k] = __ldg(p + (size_t)k * C);
}

template <int l>
__device__ __forceinline__ void store_col(float* p, const Col<l>& v, int C) {
#pragma unroll
  for (int k = 0; k < 2 * l + 1; ++k) p[(size_t)k * C] = v[k];
}

// v <- Z(sgn t) v; tr[m] = (cos m t, sin m t); rows k and 2l - k pair up
// at frequency m = l - k
template <int l>
__device__ __forceinline__ void zrot(Col<l>& v, const float2* tr, float sgn) {
#pragma unroll
  for (int k = 0; k < l; ++k) {
    const float2 cs = tr[l - k];
    const float s = sgn * cs.y;
    const float h = v[k], r = v[2 * l - k];
    v[k] = fmaf(cs.x, h, s * r);
    v[2 * l - k] = fmaf(cs.x, r, -s * h);
  }
}

// <p, Omega h> = sum_i f_i p_i h_rev(i)
template <int l>
__device__ __forceinline__ float omega_dot(const Col<l>& p, const Col<l>& h) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < l; ++k) {
    const int r = 2 * l - k;
    acc = fmaf((float)(l - k), fmaf(p[k], h[r], -p[r] * h[k]), acc);
  }
  return acc;
}

// w[rows] += t C_blk u[cols] over block b of slot s
template <int l, int s, int b>
__device__ __forceinline__ void block_apply(Col<l>& w, const Col<l>& u,
                                            float t) {
  constexpr int R = blk_rows(l, s, b), Q = blk_cols(l, s, b);
  constexpr int nr = grp_size(l, R), nq = grp_size(l, Q);
  constexpr int r0 = grp_first(l, R), q0 = grp_first(l, Q);
  constexpr int off = blk_offset(l, s, b);
#pragma unroll (l <= kUnrollDegree ? 64 : 1)
  for (int i = 0; i < nr; ++i) {
    float acc = 0.f;
#pragma unroll (l <= kUnrollDegree ? 64 : 1)
    for (int j = 0; j < nq; ++j)
      acc = fmaf(coef<l>(off + i * nq + j), u[q0 + 2 * j], acc);
    w[r0 + 2 * i] = fmaf(t, acc, w[r0 + 2 * i]);
  }
}

// w += d u = sum over slots s >= S0 of t_s C_s u; tb[m] = (cos m b, sin m b)
template <int l, int S0 = 0>
__device__ __forceinline__ void apply_d(Col<l>& w, const Col<l>& u,
                                        const float2* tb) {
  if constexpr (S0 <= 2 * l) {
    constexpr int m = slot_m(l, S0);
    const float t = S0 <= l ? tb[m].x : tb[m].y;
    block_apply<l, S0, 0>(w, u, t);
    if constexpr (m > 0) block_apply<l, S0, 1>(w, u, t);
    apply_d<l, S0 + 1>(w, u, tb);
  }
}

// Block b of slot s in the backward: w[rows] += t C_blk u[cols] as
// forward, du[cols] += t C_blk^T gw[rows]; returns <gw[rows], C_blk u>.
template <int l, int s, int b>
__device__ __forceinline__ float block_adjoint(Col<l>& w, Col<l>& du,
                                               const Col<l>& u,
                                               const Col<l>& gw, float t) {
  constexpr int R = blk_rows(l, s, b), Q = blk_cols(l, s, b);
  constexpr int nr = grp_size(l, R), nq = grp_size(l, Q);
  constexpr int r0 = grp_first(l, R), q0 = grp_first(l, Q);
  constexpr int off = blk_offset(l, s, b);
  float dt = 0.f;
#pragma unroll (l <= kUnrollDegree ? 64 : 1)
  for (int i = 0; i < nr; ++i) {
    const float g = gw[r0 + 2 * i], tg = t * g;
    float acc = 0.f;
#pragma unroll (l <= kUnrollDegree ? 64 : 1)
    for (int j = 0; j < nq; ++j) {
      const float c = coef<l>(off + i * nq + j);
      acc = fmaf(c, u[q0 + 2 * j], acc);
      du[q0 + 2 * j] = fmaf(c, tg, du[q0 + 2 * j]);
    }
    w[r0 + 2 * i] = fmaf(t, acc, w[r0 + 2 * i]);
    dt = fmaf(g, acc, dt);
  }
  return dt;
}

// w += d u and du += d^T gw over slots s >= S0; returns their part of
// d beta = sum_s <gw, C_s u> dt_s/db
template <int l, int S0 = 0>
__device__ __forceinline__ float adjoint_d(Col<l>& w, Col<l>& du,
                                           const Col<l>& u, const Col<l>& gw,
                                           const float2* tb) {
  if constexpr (S0 <= 2 * l) {
    constexpr int m = slot_m(l, S0);
    const float t = S0 <= l ? tb[m].x : tb[m].y;
    const float dt_db = S0 <= l ? -(float)m * tb[m].y : (float)m * tb[m].x;
    float dt = block_adjoint<l, S0, 0>(w, du, u, gw, t);
    if constexpr (m > 0) dt += block_adjoint<l, S0, 1>(w, du, u, gw, t);
    return fmaf(dt, dt_db, adjoint_d<l, S0 + 1>(w, du, u, gw, tb));
  } else {
    return 0.f;
  }
}

// tr[(s * 3 + r) * n + m] = (cos m t, sin m t) of angle r of sample b0 + s,
// m < n, the angles (-g, -b, -a) with `transpose`; samples past the batch
// get (1, 0)
__device__ __forceinline__ void stage_trig(float2* tr, const float* angles,
                                           int B, int b0, int nb, int n,
                                           int transpose) {
  for (int e = threadIdx.x; e < nb * 3 * n; e += blockDim.x) {
    const int sr = e / n, m = e - sr * n;
    const int smp = sr / 3, r = sr - 3 * smp;
    float s = 0.f, c = 1.f;
    if (b0 + smp < B) {
      const float* a = angles + 3LL * (b0 + smp);
      const float th = transpose ? -a[2 - r] : a[r];
      sincosf((float)m * th, &s, &c);
    }
    tr[e] = make_float2(c, s);
  }
}

// A thread's place: degree l, sample b0 + s of the block's nb (from b0),
// channel c; whether that column exists; its offset at row l^2 within a
// sample (row) and in a (B, S, C) tensor (off).
struct Place {
  int l, b0, s, c;
  bool active;
  long long row, off;
};

__device__ __forceinline__ Place place(int L, int B, int C, int nb, int ct,
                                       int ctiles) {
  Place q;
  q.l = L - (int)blockIdx.y;
  q.b0 = (int)(blockIdx.x / ctiles) * nb;
  q.s = (int)threadIdx.x / ct;
  q.c = (int)(blockIdx.x % ctiles) * ct + (int)threadIdx.x % ct;
  q.active = q.b0 + q.s < B && q.c < C;
  q.row = (long long)q.l * q.l * C + q.c;
  q.off = (long long)(q.b0 + q.s) * (L + 1) * (L + 1) * C + q.row;
  return q;
}

// Degree l of a forward block, run by each of its threads; tr is its
// sample's trig, angle r's at tr + r (l + 1).
template <int l>
__device__ __forceinline__ void fwd_column(const Place& q, const float2* tr,
                                           const float* x, float* out,
                                           int C) {
  constexpr int n = l + 1;
  if (!q.active) return;
  Col<l> u, w;
  load_col<l>(u, x, C);
  zrot<l>(u, tr + 2 * n, 1.f);                 // u = Z(g) x
#pragma unroll
  for (int k = 0; k < 2 * l + 1; ++k) w[k] = 0.f;
  apply_d<l>(w, u, tr + n);                    // w = d(b) u
  zrot<l>(w, tr, 1.f);                         // out = Z(a) w
  store_col<l>(out, w, C);
}

// Degree l of a backward block: the column's terms of (da, db, dg) at the
// angles it ran, zero for a thread without a column; dx unless it is null.
template <int l>
__device__ __forceinline__ float3 bwd_column(const Place& q, const float2* tr,
                                             const float* x,
                                             const float* dout, float* dx,
                                             int C) {
  constexpr int n = l + 1;
  float3 dang = make_float3(0.f, 0.f, 0.f);
  if (!q.active) return dang;
  Col<l> gw, u, w, du;
  load_col<l>(gw, dout, C);
  load_col<l>(u, x, C);
  zrot<l>(gw, tr, -1.f);                       // gw = Z(-a) G
  zrot<l>(u, tr + 2 * n, 1.f);                 // u = Z(g) x
#pragma unroll
  for (int k = 0; k < 2 * l + 1; ++k) w[k] = du[k] = 0.f;
  dang.y = adjoint_d<l>(w, du, u, gw, tr + n);  // w = d u, du = d^T gw
  dang.x = omega_dot<l>(gw, w);                // da = <gw, Omega w>
  dang.z = omega_dot<l>(du, u);                // dg = <du, Omega u>
  if (dx != nullptr) {
    zrot<l>(du, tr + 2 * n, -1.f);             // dx = Z(-g) du
    store_col<l>(dx, du, C);
  }
  return dang;
}

// degree q.l (<= kCap) through its instantiation; smem holds the block's
// trig, (l + 1) float2 per sample and angle
template <int kCap>
__device__ __forceinline__ void fwd_degree(const Place& q, const float2* smem,
                                           const float* x, float* out,
                                           int C) {
  if constexpr (kCap > 0) {
    if (q.l < kCap) {
      fwd_degree<kCap - 1>(q, smem, x, out, C);
      return;
    }
  }
  fwd_column<kCap>(q, smem + q.s * 3 * (kCap + 1), x, out, C);
}

template <int kCap>
__device__ __forceinline__ float3 bwd_degree(const Place& q,
                                             const float2* smem,
                                             const float* x,
                                             const float* dout, float* dx,
                                             int C) {
  if constexpr (kCap > 0) {
    if (q.l < kCap) return bwd_degree<kCap - 1>(q, smem, x, dout, dx, C);
  }
  return bwd_column<kCap>(q, smem + q.s * 3 * (kCap + 1), x, dout, dx, C);
}

// Degrees L <= kCap; shared memory: the trig, nb * 3 (L+1) float2 (the
// backward then 3 nb ct floats of column sums). The trig is staged before
// anything else is computed: sincosf's slow path is a call, and only the
// kernel's parameters are live across it.
template <int kCap>
__global__ void __launch_bounds__(kThreads)
wigner_block_fwd_kernel(const float* __restrict__ angles,
                        const float* __restrict__ x,
                        float* __restrict__ out, int B, int L, int C, int nb,
                        int ct, int ctiles, int per_sample, int transpose) {
  extern __shared__ float2 smem[];
  stage_trig(smem, angles, B, (int)(blockIdx.x / ctiles) * nb, nb,
             L - (int)blockIdx.y + 1, transpose);
  __syncthreads();
  const Place q = place(L, B, C, nb, ct, ctiles);
  fwd_degree<kCap>(q, smem, x + (per_sample ? q.off : q.row), out + q.off,
                   C);
}

template <int kCap>
__global__ void __launch_bounds__(kThreads)
wigner_block_bwd_kernel(const float* __restrict__ angles,
                        const float* __restrict__ x,
                        const float* __restrict__ dout,
                        float* __restrict__ dx, float* __restrict__ partial,
                        int B, int L, int C, int nb, int ct, int ctiles,
                        int per_sample, int transpose) {
  extern __shared__ float2 smem[];
  stage_trig(smem, angles, B, (int)(blockIdx.x / ctiles) * nb, nb,
             L - (int)blockIdx.y + 1, transpose);
  __syncthreads();
  const Place q = place(L, B, C, nb, ct, ctiles);
  const int nt = (int)blockDim.x, t = (int)threadIdx.x;
  const float3 dang = bwd_degree<kCap>(
      q, smem, x + (per_sample ? q.off : q.row), dout + q.off,
      dx != nullptr ? dx + q.off : nullptr, C);
  float* red = reinterpret_cast<float*>(smem + nb * 3 * (L + 1));  // 3 nt
  red[t] = dang.x;
  red[nt + t] = dang.y;
  red[2 * nt + t] = dang.z;
  __syncthreads();
  const int slot = (int)blockIdx.y * ctiles + (int)(blockIdx.x % ctiles);
  for (int e = t; e < 3 * nb; e += nt) {      // e = 3 s + r
    const int s = e / 3, r = e - 3 * s, b = q.b0 + s;
    if (b >= B) break;
    const float* v = red + r * nt + s * ct;
    float acc = 0.f;
    for (int c = 0; c < ct; ++c) acc += v[c];
    // W^T ran at (-g, -b, -a): d angle r is minus the term of angle 2 - r
    if (transpose)
      partial[((long long)slot * B + b) * 3 + 2 - r] = -acc;
    else
      partial[((long long)slot * B + b) * 3 + r] = acc;
  }
}

// dangles[b, r] = sum over slots, in slot order, of partial[slot, b, r]
__global__ void wigner_block_sum_kernel(const float* __restrict__ partial,
                                        float* __restrict__ dangles, int B,
                                        int slots) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= 3LL * B) return;
  float acc = 0.f;
  for (int sl = 0; sl < slots; ++sl) acc += partial[sl * 3LL * B + k];
  dangles[k] = acc;
}

using FwdKernel = void (*)(const float*, const float*, float*, int, int, int,
                           int, int, int, int, int);
using BwdKernel = void (*)(const float*, const float*, const float*, float*,
                           float*, int, int, int, int, int, int, int, int);

// The instantiations: one per cap on the degree, the launch taking the
// smallest cap >= L.
constexpr int kCaps[] = {3, 6, 10, kMaxDegree};

int cap_index(int L) {
  int i = 0;
  while (kCaps[i] < L) ++i;
  return i;
}

FwdKernel fwd_kernel(int L) {
  static const FwdKernel table[] = {
      &wigner_block_fwd_kernel<kCaps[0]>, &wigner_block_fwd_kernel<kCaps[1]>,
      &wigner_block_fwd_kernel<kCaps[2]>, &wigner_block_fwd_kernel<kCaps[3]>};
  return table[cap_index(L)];
}

BwdKernel bwd_kernel(int L) {
  static const BwdKernel table[] = {
      &wigner_block_bwd_kernel<kCaps[0]>, &wigner_block_bwd_kernel<kCaps[1]>,
      &wigner_block_bwd_kernel<kCaps[2]>, &wigner_block_bwd_kernel<kCaps[3]>};
  return table[cap_index(L)];
}

// Threads of a block over nb samples x ct channels, ctiles channel tiles.
struct Plan {
  int nb, ct, ctiles;
  dim3 grid, block;
  size_t smem;
};

Plan plan(int B, int L, int C, bool backward) {
  Plan p;
  p.ctiles = (C + kThreads - 1) / kThreads;
  p.ct = (C + p.ctiles - 1) / p.ctiles;
  p.nb = kThreads / p.ct;
  // trig of nb samples, and the backward's 3 sums a thread, within 48 KB
  const size_t per_sample = sizeof(float2) * 3 * (L + 1)
                            + (backward ? sizeof(float) * 3 * p.ct : 0);
  if ((size_t)p.nb * per_sample > kSmemLimit)
    p.nb = (int)(kSmemLimit / per_sample);
  if (p.nb > B) p.nb = B;
  p.grid = dim3((unsigned)(((B + p.nb - 1) / p.nb) * p.ctiles),
                (unsigned)(L + 1));
  p.block = dim3((unsigned)(p.nb * p.ct));
  p.smem = (size_t)p.nb * per_sample;
  return p;
}

bool takes(int B, int L, int C) {
  return B >= 0 && L >= 0 && L <= kMaxDegree && C > 0;
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError();
// 1 marks arguments the kernels do not take. per_sample is 0 for a
// spectrum x shared by the batch and 1 for a (B, S, C) one; transpose is 1
// for W^T.

// The coefficient table (kCoefs floats from host memory, the layout in the
// head note) into the current device's constant and global memory: once
// per device, before any launch.
extern "C" int wigner_block_load_coeffs(const void* c, int n) {
  if (c == nullptr || n != kCoefs) return 1;
  const float* f = (const float*)c;
  const int rc = (int)cudaMemcpyToSymbol(kC, f, sizeof(float) * kConstCoefs);
  if (rc != 0) return rc;
  return (int)cudaMemcpyToSymbol(kCHigh, f + kConstCoefs,
                                 sizeof(float) * (kCoefs - kConstCoefs));
}

// out = W(angles) x (W^T x with transpose)
extern "C" int wigner_block_fwd(const void* angles, const void* x, void* out,
                                int B, int L, int C, int per_sample,
                                int transpose, void* stream) {
  if (!takes(B, L, C)) return 1;
  if (B == 0) return 0;
  const Plan p = plan(B, L, C, false);
  const FwdKernel k = fwd_kernel(L);
  k<<<p.grid, p.block, p.smem, (cudaStream_t)stream>>>(
      (const float*)angles, (const float*)x, (float*)out, B, L, C, p.nb,
      p.ct, p.ctiles, per_sample, transpose);
  return (int)cudaGetLastError();
}

// Slots of the backward's scratch a sample: its (L + 1) degrees times its
// channel tiles; 0 for arguments the kernels do not take.
extern "C" int wigner_block_bwd_slots(int L, int C) {
  if (!takes(1, L, C)) return 0;
  return (L + 1) * plan(1, L, C, true).ctiles;
}

// From the cotangent dout of out (B, S, C): dx (B, S, C) per sample
// (skipped when dx is null) and dangles (B, 3). `partial` is scratch of
// (slots, B, 3) floats, slots from wigner_block_bwd_slots.
extern "C" int wigner_block_bwd(const void* angles, const void* x,
                                const void* dout, void* dx, void* dangles,
                                void* partial, int B, int L, int C,
                                int per_sample, int transpose, void* stream) {
  if (!takes(B, L, C) || partial == nullptr) return 1;
  if (B == 0) return 0;
  const Plan p = plan(B, L, C, true);
  cudaStream_t st = (cudaStream_t)stream;
  const BwdKernel k = bwd_kernel(L);
  k<<<p.grid, p.block, p.smem, st>>>(
      (const float*)angles, (const float*)x, (const float*)dout, (float*)dx,
      (float*)partial, B, L, C, p.nb, p.ct, p.ctiles, per_sample, transpose);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int slots = (L + 1) * p.ctiles;
  const int n = 3 * B;
  wigner_block_sum_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      (const float*)partial, (float*)dangles, B, slots);
  return (int)cudaGetLastError();
}
