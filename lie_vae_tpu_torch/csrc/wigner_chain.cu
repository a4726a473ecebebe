// The block-Wigner chain out = Z(a) J Z(b) J Z(g) x on a real direct-sum
// spectrum, forward and backward, for one NVIDIA Hopper card (sm_90a).
//
// Replaces the TPU kernel lie_vae_tpu/ops/kernels/wigner_fused.py::
// _chain_kernel (:127): run without residuals through _plain_kernel (:158,
// call :208) for inference (wigner_chain_fwd, K1), run with residuals (call
// :194) as the forward of its custom VJP (wigner_chain_fwd_res, K2
// forward), and that VJP's backward op_bwd (:240-261), which runs the same
// kernel on dout at (-g, -b, -a) and then takes six (B, SC) x (SC, L+1)
// reductions in XLA for the trig-feature cotangents (wigner_chain_bwd, K2
// backward). The TPU kernel rides a flat (B, S*C) lane layout with
// Kronecker-expanded (SC, SC) constants, because a TPU has no lane gathers.
// The function and its contract carry over, the layout does not:
//
//   angles (B, 3) float32, ZYZ (a, b, g), already flipped by the caller for
//   the transpose W^T, which is the same chain at (-g, -b, -a);
//   x shared (S, C), read in place at stride 0, or per sample (B, S, C);
//   out (B, S, C) float32, S = (L+1)^2, any 0 <= L <= 16 and any C >= 1.
//   (Z(t) h)_i = cos(f_i t) h_i + sin(f_i t) h_rev(i), f_i = l - (i - l^2)
//   for row i in degree block l, rev(i) = l^2 + (l^2 + 2l - i);
//   J = diag(J_0 .. J_16), constant, symmetric.
//
// The chain is block-diagonal by degree: each column (b, l, c), the d = 2l+1
// rows of degree l of sample b in channel c, goes through Z, J_l, Z, J_l, Z
// on its own. So one thread takes one column and keeps its d-vector in
// registers through every pass (d a template parameter, loops unrolled):
// a z-rotation is one 2x2 rotation per pair (k, d-1-k), both in the
// thread's registers; a J_l product is a run of FMAs whose J operands are
// compile-time offsets into __constant__ memory (no load instruction), and
// only the entries that J_l's structure lets be non-zero are multiplied
// (j_coupled below: 43 of 169 at l = 6). No barrier sits between passes and
// no index is divided per element.
//
// Launch plan. blockIdx.y is the degree, heaviest first (l = L - y), so
// every warp works on one l (uniform J reads, no divergence) and the l = L
// blocks start first. blockIdx.x takes nb samples times a tile of ct
// channels (nb * ct <= 128 threads, the lanes over (b, c), c fastest; C
// above 128 is cut into equal channel tiles). The block stages cos/sin(m t),
// m <= l, of its samples' three angles in shared memory (full-precision
// sincosf, nb * 3 (l+1) of them over the block's threads instead of
// 3 (l+1) per thread), then one barrier, then each thread runs its column.
// Reads and writes go straight to device memory: a row of a sample is C
// contiguous floats and a sample's degree-l slab d * C of them, which one
// warp walks row by row, so L1 and L2 assemble whole sectors; a shared
// spectrum stays in L1/L2 for every sample. One kernel is built per cap on
// the degree (3, 6, 10, 16) and a launch takes the smallest cap >= L: its
// registers follow the cap's largest column.
//
// Tried on an H100 against this design (PERF.md): staging each block's
// outputs in shared memory so that warps store whole contiguous runs was
// slower at every shape timed; one instantiation per L took about twice
// the build time at about the same speed; issuing the column's loads
// before the trig staging was a little faster but spilled registers at
// L = 6.
//
// Forward: y = J Z(g) x, z = J Z(b) y, out = Z(a) z; with residuals it also
// writes y and z (B, S, C) for the backward.
//
// Backward. Z(t)^T = Z(-t) and J is symmetric, so for a cotangent G of out,
//   A = J Z(-a) G,   V = J Z(-b) A,   dx = Z(-g) V,
// and with (Z'(t) h)_i = -|f_i| sin(|f_i| t) h_i + f_i cos(|f_i| t) h_rev(i)
//   da = <G, Z'(a) z>,   db = <A, Z'(b) y>,   dg = <V, Z'(g) x>,
// each column adding its own terms, in registers. A block sums its
// threads' terms per sample in channel order (shared memory, one thread per
// sample and angle) into scratch[(L - l) * ctiles + tile][b]; a second
// small kernel adds the (L+1) * ctiles slots of each sample in slot order.
// No atomics: a run repeats bit for bit. dx is per sample; for a shared
// spectrum the caller sums it over the batch.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32): the bytes.
// Per sample at L = 6, C = 10, K1 writes 4 S C = 1960 B of out and reads
// 12 B of angles (a shared spectrum once per call); K2's forward also
// writes y and z (5880 B in all); the backward reads y, z and dout and
// writes dx (7840 B, plus x when per sample). K1 does about 12 float32
// operations per byte it must move with dense J products and 5 with J's
// zeros skipped (K2 fewer), against the card's 20 per byte outside the
// tensor cores. No tensor cores: the work is bound by bytes at every batch,
// and TF32 keeps about 3 decimal digits, which would break the kernels'
// 1e-5 tolerance against the float32 plain chain; a wgmma/mma.sync version
// is not worth trying without a measurement that says otherwise. All
// arithmetic is float32; the JAX package's bfloat16 products, a choice made
// for the TPU's matrix unit, are not copied.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxDegree = 16;        // the degrees ops/jd_tables.npz holds
constexpr int kThreads = 128;         // threads a block at most
constexpr size_t kSmemLimit = 48 * 1024;

// first packed index of J_l: sum_{k<l} (2k+1)^2 = l (4 l^2 - 1) / 3
__host__ __device__ constexpr int j_offset(int l) {
  return l * (4 * l * l - 1) / 3;
}

constexpr int kJSize = j_offset(kMaxDegree + 1);   // 6545 floats, 26 KB

// J_0 .. J_16, each row-major, set once per device (wigner_chain_load_j)
__constant__ float kJ[kJSize];

// Can J_l[i][k] be non-zero? Row i has frequency f = l - i; with s = (f > 0)
// and p = f odd, J_l couples i and k only when s ^ p agree, and then their
// signs agree exactly when s ^ p equals l's parity (J's real-basis
// structure; the Python twin j_coupled is tested against every table).
__host__ __device__ constexpr bool j_coupled(int l, int i, int k) {
  const int fi = l - i, fk = l - k;
  const bool qi = (fi > 0) != ((fi & 1) != 0);
  const bool qk = (fk > 0) != ((fk & 1) != 0);
  return qi == qk && (((fi > 0) == (fk > 0)) == (qi == ((l & 1) != 0)));
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

// v <- Z(sgn t) v; tr[m] = (cos m t, sin m t); sgn = -1 gives Z(t)^T
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

// <p, d/dt Z(t) h>: pair (k, k') = (k, 2l - k) has m = l - k and
// (Z'h)_k = m (c h_k' - s h_k), (Z'h)_k' = -m (s h_k' + c h_k)
template <int l>
__device__ __forceinline__ float dzrot_dot(const Col<l>& p, const Col<l>& h,
                                           const float2* tr) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < l; ++k) {
    const float2 cs = tr[l - k];
    const int r = 2 * l - k;
    const float u = fmaf(cs.x, h[r], -cs.y * h[k]);
    const float w = fmaf(cs.y, h[r], cs.x * h[k]);
    acc = fmaf((float)(l - k), fmaf(p[k], u, -p[r] * w), acc);
  }
  return acc;
}

// v <- J_l v over J_l's coupled entries
template <int l>
__device__ __forceinline__ void jmul(Col<l>& v) {
  constexpr int d = 2 * l + 1, o = j_offset(l);
  float w[d];
#pragma unroll
  for (int i = 0; i < d; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < d; ++k)
      if (j_coupled(l, i, k)) acc = fmaf(kJ[o + i * d + k], v[k], acc);
    w[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < d; ++i) v[i] = w[i];
}

// tr[(s * 3 + r) * n + m] = (cos m t, sin m t) of angle r of sample b0 + s,
// m < n; samples past the batch get (1, 0)
__device__ __forceinline__ void stage_trig(float2* tr, const float* angles,
                                           int B, int b0, int nb, int n) {
  for (int e = threadIdx.x; e < nb * 3 * n; e += blockDim.x) {
    const int sr = e / n, m = e - sr * n;
    float s = 0.f, c = 1.f;
    if (b0 + sr / 3 < B) sincosf((float)m * angles[3LL * b0 + sr], &s, &c);
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

// The block's trig, read by every column of the block.
struct Trig {
  float2* smem;
  const float* angles;
  int B, nb;
};

// Degree l of a forward block, run by each of its threads: the column's
// loads go out between the block's trig staging and its barrier, so their
// latency hides behind the barrier's wait.
template <int l, bool kResiduals>
__device__ __forceinline__ void fwd_column(const Place& q, const Trig& tg,
                                           const float* x, float* out,
                                           float* y, float* z, int C) {
  constexpr int n = l + 1;
  stage_trig(tg.smem, tg.angles, tg.B, q.b0, tg.nb, n);
  Col<l> v;
  if (q.active) load_col<l>(v, x, C);
  __syncthreads();
  if (!q.active) return;
  const float2* tr = tg.smem + q.s * 3 * n;
  zrot<l>(v, tr + 2 * n, 1.f);                 // y = J Z(g) x
  jmul<l>(v);
  if (kResiduals) store_col<l>(y, v, C);
  zrot<l>(v, tr + n, 1.f);                     // z = J Z(b) y
  jmul<l>(v);
  if (kResiduals) store_col<l>(z, v, C);
  zrot<l>(v, tr, 1.f);                         // out = Z(a) z
  store_col<l>(out, v, C);
}

// Degree l of a backward block: the column's terms of (da, db, dg), zero
// for a thread without a column; dx unless it is null. Its four columns
// are loaded after the barrier: before it they held more registers and
// ran slower on the H100.
template <int l>
__device__ __forceinline__ float3 bwd_column(const Place& q, const Trig& tg,
                                             const float* x, const float* y,
                                             const float* z,
                                             const float* dout, float* dx,
                                             int C) {
  constexpr int n = l + 1;
  stage_trig(tg.smem, tg.angles, tg.B, q.b0, tg.nb, n);
  __syncthreads();
  float3 dang = make_float3(0.f, 0.f, 0.f);
  if (!q.active) return dang;
  Col<l> g, hz, hy, hx;
  load_col<l>(g, dout, C);
  load_col<l>(hz, z, C);
  load_col<l>(hy, y, C);
  load_col<l>(hx, x, C);
  const float2* tr = tg.smem + q.s * 3 * n;
  dang.x = dzrot_dot<l>(g, hz, tr);            // da = <G, Z'(a) z>
  zrot<l>(g, tr, -1.f);                        // A = J Z(-a) G
  jmul<l>(g);
  dang.y = dzrot_dot<l>(g, hy, tr + n);        // db = <A, Z'(b) y>
  zrot<l>(g, tr + n, -1.f);                    // V = J Z(-b) A
  jmul<l>(g);
  dang.z = dzrot_dot<l>(g, hx, tr + 2 * n);    // dg = <V, Z'(g) x>
  if (dx != nullptr) {
    zrot<l>(g, tr + 2 * n, -1.f);              // dx = Z(-g) V
    store_col<l>(dx, g, C);
  }
  return dang;
}

// degree q.l (<= kCap) through its instantiation
template <int kCap, bool kResiduals>
__device__ __forceinline__ void fwd_degree(const Place& q, const Trig& tg,
                                           const float* x, float* out,
                                           float* y, float* z, int C) {
  if constexpr (kCap > 0) {
    if (q.l < kCap) {
      fwd_degree<kCap - 1, kResiduals>(q, tg, x, out, y, z, C);
      return;
    }
  }
  fwd_column<kCap, kResiduals>(q, tg, x, out, y, z, C);
}

template <int kCap>
__device__ __forceinline__ float3 bwd_degree(const Place& q, const Trig& tg,
                                             const float* x, const float* y,
                                             const float* z,
                                             const float* dout, float* dx,
                                             int C) {
  if constexpr (kCap > 0) {
    if (q.l < kCap) return bwd_degree<kCap - 1>(q, tg, x, y, z, dout, dx, C);
  }
  return bwd_column<kCap>(q, tg, x, y, z, dout, dx, C);
}

// Degrees L <= kCap; shared memory: the trig, nb * 3 (L+1) float2 (the
// backward then 3 nb ct floats of column sums).
template <int kCap, bool kResiduals>
__global__ void __launch_bounds__(kThreads)
wigner_chain_fwd_kernel(const float* __restrict__ angles,
                        const float* __restrict__ x,
                        float* __restrict__ out, float* __restrict__ y,
                        float* __restrict__ z, int B, int L, int C, int nb,
                        int ct, int ctiles, int per_sample) {
  extern __shared__ float2 smem[];
  const Place q = place(L, B, C, nb, ct, ctiles);
  fwd_degree<kCap, kResiduals>(q, Trig{smem, angles, B, nb},
                               x + (per_sample ? q.off : q.row), out + q.off,
                               kResiduals ? y + q.off : nullptr,
                               kResiduals ? z + q.off : nullptr, C);
}

template <int kCap>
__global__ void __launch_bounds__(kThreads)
wigner_chain_bwd_kernel(const float* __restrict__ angles,
                        const float* __restrict__ x,
                        const float* __restrict__ y,
                        const float* __restrict__ z,
                        const float* __restrict__ dout,
                        float* __restrict__ dx, float* __restrict__ partial,
                        int B, int L, int C, int nb, int ct, int ctiles,
                        int per_sample) {
  extern __shared__ float2 smem[];
  const Place q = place(L, B, C, nb, ct, ctiles);
  const int nt = (int)blockDim.x, t = (int)threadIdx.x;
  const float3 dang = bwd_degree<kCap>(
      q, Trig{smem, angles, B, nb}, x + (per_sample ? q.off : q.row),
      y + q.off, z + q.off, dout + q.off,
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
    partial[((long long)slot * B + b) * 3 + r] = acc;
  }
}

// dangles[b, r] = sum over slots, in slot order, of partial[slot, b, r]
__global__ void wigner_chain_sum_kernel(const float* __restrict__ partial,
                                        float* __restrict__ dangles, int B,
                                        int slots) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= 3LL * B) return;
  float acc = 0.f;
  for (int sl = 0; sl < slots; ++sl) acc += partial[sl * 3LL * B + k];
  dangles[k] = acc;
}

using FwdKernel = void (*)(const float*, const float*, float*, float*,
                           float*, int, int, int, int, int, int, int);
using BwdKernel = void (*)(const float*, const float*, const float*,
                           const float*, const float*, float*, float*, int,
                           int, int, int, int, int, int);

// The instantiations: one per cap on the degree, the launch taking the
// smallest cap >= L. A kernel's registers follow its largest column, and
// every degree in a cap would be built again in each larger one.
constexpr int kCaps[] = {3, 6, 10, kMaxDegree};

int cap_index(int L) {
  int i = 0;
  while (kCaps[i] < L) ++i;
  return i;
}

template <bool kResiduals>
FwdKernel fwd_kernel(int L) {
  static const FwdKernel table[] = {
      &wigner_chain_fwd_kernel<kCaps[0], kResiduals>,
      &wigner_chain_fwd_kernel<kCaps[1], kResiduals>,
      &wigner_chain_fwd_kernel<kCaps[2], kResiduals>,
      &wigner_chain_fwd_kernel<kCaps[3], kResiduals>};
  return table[cap_index(L)];
}

BwdKernel bwd_kernel(int L) {
  static const BwdKernel table[] = {
      &wigner_chain_bwd_kernel<kCaps[0]>, &wigner_chain_bwd_kernel<kCaps[1]>,
      &wigner_chain_bwd_kernel<kCaps[2]>, &wigner_chain_bwd_kernel<kCaps[3]>};
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

int launch_fwd(const void* angles, const void* x, void* out, void* y,
               void* z, int B, int L, int C, int per_sample, void* stream) {
  if (!takes(B, L, C)) return 1;
  if (B == 0) return 0;
  const Plan p = plan(B, L, C, false);
  const FwdKernel k = y != nullptr ? fwd_kernel<true>(L)
                                   : fwd_kernel<false>(L);
  k<<<p.grid, p.block, p.smem, (cudaStream_t)stream>>>(
      (const float*)angles, (const float*)x, (float*)out, (float*)y,
      (float*)z, B, L, C, p.nb, p.ct, p.ctiles, per_sample);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError();
// 1 marks arguments the kernels do not take. per_sample is 0 for a
// spectrum x shared by the batch and 1 for a (B, S, C) one.

// J_0 .. J_16 packed row-major, kJSize floats from host memory, into the
// current device's constant memory: once per device, before any launch.
extern "C" int wigner_chain_load_j(const void* j, int n) {
  if (j == nullptr || n != kJSize) return 1;
  return (int)cudaMemcpyToSymbol(kJ, j, sizeof(float) * kJSize);
}

// out = W(angles) x
extern "C" int wigner_chain_fwd(const void* angles, const void* x, void* out,
                                int B, int L, int C, int per_sample,
                                void* stream) {
  return launch_fwd(angles, x, out, nullptr, nullptr, B, L, C, per_sample,
                    stream);
}

// out, and the residuals y = J Z(g) x and z = J Z(b) y, (B, S, C) each
extern "C" int wigner_chain_fwd_res(const void* angles, const void* x,
                                    void* out, void* y, void* z, int B,
                                    int L, int C, int per_sample,
                                    void* stream) {
  if (y == nullptr || z == nullptr) return 1;
  return launch_fwd(angles, x, out, y, z, B, L, C, per_sample, stream);
}

// Slots of the backward's scratch a sample: its (L + 1) degrees times its
// channel tiles; 0 for arguments the kernels do not take.
extern "C" int wigner_chain_bwd_slots(int L, int C) {
  if (!takes(1, L, C)) return 0;
  return (L + 1) * plan(1, L, C, true).ctiles;
}

// From the cotangent dout of out (B, S, C) and the residuals y, z: dx
// (B, S, C) per sample (skipped when dx is null) and dangles (B, 3).
// `partial` is scratch of (slots, B, 3) floats, slots from
// wigner_chain_bwd_slots.
extern "C" int wigner_chain_bwd(const void* angles, const void* x,
                                const void* y, const void* z,
                                const void* dout, void* dx, void* dangles,
                                void* partial, int B, int L, int C,
                                int per_sample, void* stream) {
  if (!takes(B, L, C) || partial == nullptr) return 1;
  if (B == 0) return 0;
  const Plan p = plan(B, L, C, true);
  cudaStream_t st = (cudaStream_t)stream;
  const BwdKernel k = bwd_kernel(L);
  k<<<p.grid, p.block, p.smem, st>>>(
      (const float*)angles, (const float*)x, (const float*)y,
      (const float*)z, (const float*)dout, (float*)dx, (float*)partial, B, L,
      C, p.nb, p.ct, p.ctiles, per_sample);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int slots = (L + 1) * p.ctiles;
  const int n = 3 * B;
  wigner_chain_sum_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      (const float*)partial, (float*)dangles, B, slots);
  return (int)cudaGetLastError();
}
