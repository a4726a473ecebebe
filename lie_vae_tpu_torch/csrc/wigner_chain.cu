// The block-Wigner chain out = Z(a) J Z(b) J Z(g) x on a real direct-sum
// spectrum, forward and backward, for one NVIDIA Hopper card (sm_90a).
//
// Replaces the TPU kernel lie_vae_tpu/ops/kernels/wigner_fused.py::
// _chain_kernel: run without residuals (through _plain_kernel, for
// inference: wigner_chain_fwd), run with residuals (the forward of its
// custom VJP: wigner_chain_fwd_res), and the backward op_bwd, which runs
// the same kernel on dout at (-g, -b, -a) and then takes six
// (B, SC) x (SC, L+1) reductions in XLA for the trig-feature cotangents
// (wigner_chain_bwd). That kernel rides a flat (B, S*C) lane layout with
// Kronecker-expanded (SC, SC) constants, 0/+-1 selection products for the
// trig features and an x[rev] gather done outside the kernel: all ways
// around the TPU's lack of lane gathers. A GPU gathers from shared memory,
// so none of that carries over; the function and its contract do:
//
//   angles (B, 3) float32, ZYZ (a, b, g);
//   x shared (S, C) or per-sample (B, S, C) float32, S = (L+1)^2;
//   out (B, S, C) float32.
//   (Z(t) h)_i = cos(f_i t) h_i + sin(f_i t) h_rev(i), with f_i = l - (i - l^2)
//   for row i in degree block l and rev(i) = l^2 + (l^2 + 2l - i);
//   J = diag(J_0 .. J_L), packed row-major block after block (455 floats
//   for L = 6). W^T is the same chain at (-g, -b, -a): the caller flips the
//   angles, so these entry points take the angles of the chain they run.
//
// Forward design (first version: simple and right). One thread block takes
// one sample and a tile of its channels; channels are independent columns
// of the chain, so the tile is sized to keep shared memory under the
// default 48 KB for every L the tables hold (L <= 16) and any C. The block
// stages the spectrum tile and J in shared memory, computes the 6(L+1)
// distinct sincosf(m t) once, then runs the chain in three passes, each
// fusing a z-rotation into the neighbouring J product:
//   y = J Z(g) x,   z = J Z(b) y,   out = Z(a) z.
// With residuals it also writes y and z, (B, S, C) each, for the backward;
// they cost 2/3 more bytes than the output alone but save the backward two
// of its five passes. A shared (S, C) spectrum is read by every block from
// the same addresses and stays in L2; it is never expanded to (B, S, C).
//
// Backward design. Z(t)^T = Z(-t) and J is symmetric, so for a cotangent
// G of out:
//   A = J Z(-a) G,   V = J Z(-b) A,   dx = Z(-g) V,
// and with d/dt (Z(t) h)_i = -|f_i| sin(|f_i| t) h_i + f_i cos(|f_i| t) h_rev(i)
// the angle gradients are
//   da = <G, Z'(a) z>,   db = <A, Z'(b) y>,   dg = <V, Z'(g) x>,
// contracted in the same three passes that make A, V and dx (no trig
// features, no XLA reductions). One block per sample and channel tile, as
// the forward; the block sums its threads' partials in a fixed tree, and
// where a sample spans several channel tiles a second kernel adds the
// per-tile partials in tile order: no atomics, so a run repeats bit for bit.
// dx is per sample; for a shared spectrum the caller sums it over the batch.
//
// All arithmetic is float32. The JAX package computes its products in
// bfloat16 by default, a choice made for the TPU's matrix unit; these
// kernels do not copy it.
//
// Bound on an H100 SXM: the bytes. Forward, 12 B of angles plus 4*S*C B of
// output per sample (plus the spectrum, once if shared), and 8*S*C B more
// with residuals; backward, the angles, y, z, dout and dx, 16*S*C + 24 B per
// sample (plus x). At the training shape (B = 64, L = 6, C = 10) that is
// 0.4 to 0.5 MB, about 0.15 us: far below one launch. There the cost is the launch
// and the latency of the dependent passes inside each block, not the
// bytes; a later version gains by shortening the passes (per-row index
// tables, more samples per block) and by fusing with the neighbours.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;               // a power of two (tree sums)
constexpr size_t kSmemLimit = 48 * 1024;

__device__ __forceinline__ int degree_of(int i) {
  int l = (int)sqrtf((float)i);
  while ((l + 1) * (l + 1) <= i) ++l;
  while (l * l > i) --l;
  return l;
}

// first packed index of J_l: sum_{k<l} (2k+1)^2 = l (4 l^2 - 1) / 3
__device__ __host__ __forceinline__ int j_offset(int l) {
  return l * (4 * l * l - 1) / 3;
}

// (Z(sgn t) h)[i, c] read from a tile h of `ct` columns; trig holds cos(m t)
// at [m] and sin(m t) at [L1 + m]; sgn = -1 gives Z(-t) = Z(t)^T.
__device__ __forceinline__ float zrot(const float* h, const float* trig,
                                      int L1, int i, int l, int c, int ct,
                                      float sgn) {
  const int f = l - (i - l * l);
  const int m = f < 0 ? -f : f;
  const float s = (f < 0 ? -sgn : sgn) * trig[L1 + m];
  const int r = 2 * l * l + 2 * l - i;
  return trig[m] * h[i * ct + c] + s * h[r * ct + c];
}

// p[i, c] * d/dt (Z(t) h)[i, c]: one term of an angle gradient
__device__ __forceinline__ float dzrot(const float* p, const float* h,
                                       const float* trig, int L1, int i,
                                       int l, int c, int ct) {
  const int f = l - (i - l * l);
  const int m = f < 0 ? -f : f;
  const int r = 2 * l * l + 2 * l - i;
  return p[i * ct + c] * ((float)f * trig[m] * h[r * ct + c]
                          - (float)m * trig[L1 + m] * h[i * ct + c]);
}

// dst[i, c] = sum_j J_l[i, j] (Z(sgn t) src)[j, c] over row i's block l
__device__ __forceinline__ void j_of_z(float* dst, const float* src,
                                       const float* jp, const float* trig,
                                       int L1, int S, int ct, float sgn) {
  for (int e = threadIdx.x; e < S * ct; e += blockDim.x) {
    const int i = e / ct, c = e - (e / ct) * ct;
    const int l = degree_of(i), o = l * l, d = 2 * l + 1;
    const float* jrow = jp + j_offset(l) + (i - o) * d;
    float acc = 0.f;
    for (int k = 0; k < d; ++k)
      acc = fmaf(jrow[k], zrot(src, trig, L1, o + k, l, c, ct, sgn), acc);
    dst[e] = acc;
  }
}

// J and the sincos of the three angles of sample b into shared memory
__device__ __forceinline__ void stage_constants(float* jp, float* trig,
                                                const float* jpacked,
                                                const float* angles, int b,
                                                int L1) {
  const int n_j = j_offset(L1);
  for (int k = threadIdx.x; k < n_j; k += blockDim.x) jp[k] = jpacked[k];
  for (int k = threadIdx.x; k < 3 * L1; k += blockDim.x) {
    const int slot = k / L1, m = k - slot * L1;
    float s, c;
    sincosf((float)m * angles[3 * (long long)b + slot], &s, &c);
    trig[2 * slot * L1 + m] = c;
    trig[2 * slot * L1 + L1 + m] = s;
  }
}

// columns c0 .. c0 + cw of the (S, C) matrix at src into a zero-padded tile
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int S, int C, int c0, int cw,
                                          int ct) {
  for (int e = threadIdx.x; e < S * ct; e += blockDim.x) {
    const int i = e / ct, c = e - (e / ct) * ct;
    dst[e] = c < cw ? src[(long long)i * C + c0 + c] : 0.f;
  }
}

__device__ __forceinline__ void store_tile(float* dst, const float* src,
                                           int S, int C, int c0, int cw,
                                           int ct) {
  for (int e = threadIdx.x; e < S * ct; e += blockDim.x) {
    const int i = e / ct, c = e - (e / ct) * ct;
    if (c < cw) dst[(long long)i * C + c0 + c] = src[e];
  }
}

template <bool kResiduals>
__global__ void wigner_chain_fwd_kernel(const float* __restrict__ angles,
                                        const float* __restrict__ x,
                                        const float* __restrict__ jpacked,
                                        float* __restrict__ out,
                                        float* __restrict__ y_out,
                                        float* __restrict__ z_out,
                                        int L, int C, int ct,
                                        long long x_batch_stride) {
  extern __shared__ float smem[];
  const int L1 = L + 1, S = L1 * L1, n_j = j_offset(L1);
  const int b = blockIdx.x, c0 = blockIdx.y * ct;
  const int cw = min(ct, C - c0);            // columns in this tile
  float* buf0 = smem;                        // S * ct
  float* buf1 = buf0 + S * ct;               // S * ct
  float* jp = buf1 + S * ct;                 // n_j
  float* trig = jp + n_j;                    // 3 angles x (cos, sin) x L1

  stage_constants(jp, trig, jpacked, angles, b, L1);
  load_tile(buf0, x + (long long)b * x_batch_stride, S, C, c0, cw, ct);
  __syncthreads();

  const float* ta = trig;
  const float* tb = trig + 2 * L1;
  const float* tg = trig + 4 * L1;
  const long long base = (long long)b * S * C;
  j_of_z(buf1, buf0, jp, tg, L1, S, ct, 1.f);     // y = J Z(g) x
  __syncthreads();
  if (kResiduals) store_tile(y_out + base, buf1, S, C, c0, cw, ct);
  j_of_z(buf0, buf1, jp, tb, L1, S, ct, 1.f);     // z = J Z(b) y
  __syncthreads();
  if (kResiduals) store_tile(z_out + base, buf0, S, C, c0, cw, ct);

  for (int e = threadIdx.x; e < S * ct; e += blockDim.x) {
    const int i = e / ct, c = e - (e / ct) * ct;
    if (c < cw)
      out[base + (long long)i * C + c0 + c] =
          zrot(buf0, ta, L1, i, degree_of(i), c, ct, 1.f);   // Z(a) z
  }
}

__global__ void wigner_chain_bwd_kernel(const float* __restrict__ angles,
                                        const float* __restrict__ x,
                                        const float* __restrict__ jpacked,
                                        const float* __restrict__ y,
                                        const float* __restrict__ z,
                                        const float* __restrict__ dout,
                                        float* __restrict__ dx,
                                        float* __restrict__ dangles,
                                        int L, int C, int ct,
                                        long long x_batch_stride) {
  extern __shared__ float smem[];
  const int L1 = L + 1, S = L1 * L1, n_j = j_offset(L1);
  const int b = blockIdx.x, c0 = blockIdx.y * ct;
  const int cw = min(ct, C - c0);
  float* bx = smem;                          // five S * ct tiles
  float* by = bx + S * ct;
  float* bz = by + S * ct;
  float* bg = bz + S * ct;                   // dout, later V
  float* ba = bg + S * ct;                   // A
  float* jp = ba + S * ct;                   // n_j
  float* trig = jp + n_j;                    // 6 * L1
  float* red = trig + 6 * L1;                // 3 * blockDim.x

  const long long base = (long long)b * S * C;
  stage_constants(jp, trig, jpacked, angles, b, L1);
  load_tile(bx, x + (long long)b * x_batch_stride, S, C, c0, cw, ct);
  load_tile(by, y + base, S, C, c0, cw, ct);
  load_tile(bz, z + base, S, C, c0, cw, ct);
  load_tile(bg, dout + base, S, C, c0, cw, ct);
  __syncthreads();

  const float* ta = trig;
  const float* tb = trig + 2 * L1;
  const float* tg = trig + 4 * L1;
  float da = 0.f, db = 0.f, dg = 0.f;
  // A = J Z(-a) G; da = <G, Z'(a) z>
  j_of_z(ba, bg, jp, ta, L1, S, ct, -1.f);
  for (int e = threadIdx.x; e < S * ct; e += blockDim.x) {
    const int i = e / ct, c = e - (e / ct) * ct;
    da += dzrot(bg, bz, ta, L1, i, degree_of(i), c, ct);
  }
  __syncthreads();
  // V = J Z(-b) A (over G, no longer needed); db = <A, Z'(b) y>
  j_of_z(bg, ba, jp, tb, L1, S, ct, -1.f);
  for (int e = threadIdx.x; e < S * ct; e += blockDim.x) {
    const int i = e / ct, c = e - (e / ct) * ct;
    db += dzrot(ba, by, tb, L1, i, degree_of(i), c, ct);
  }
  __syncthreads();
  // dx = Z(-g) V; dg = <V, Z'(g) x>
  for (int e = threadIdx.x; e < S * ct; e += blockDim.x) {
    const int i = e / ct, c = e - (e / ct) * ct;
    const int l = degree_of(i);
    if (dx != nullptr && c < cw)
      dx[base + (long long)i * C + c0 + c] =
          zrot(bg, tg, L1, i, l, c, ct, -1.f);
    dg += dzrot(bg, bx, tg, L1, i, l, c, ct);
  }

  // fixed-order tree over the block's threads
  const int t = threadIdx.x, nt = blockDim.x;
  red[t] = da;
  red[nt + t] = db;
  red[2 * nt + t] = dg;
  __syncthreads();
  for (int half = nt / 2; half > 0; half /= 2) {
    if (t < half)
      for (int r = 0; r < 3; ++r) red[r * nt + t] += red[r * nt + t + half];
    __syncthreads();
  }
  if (t == 0) {
    float* o = dangles + 3 * ((long long)b * gridDim.y + blockIdx.y);
    o[0] = red[0];
    o[1] = red[nt];
    o[2] = red[2 * nt];
  }
}

// dangles[b, r] = sum over tiles, in tile order, of partial[b, tile, r]
__global__ void sum_tiles_kernel(const float* __restrict__ partial,
                                 float* __restrict__ dangles, int B,
                                 int tiles) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= 3LL * B) return;
  const long long b = k / 3, r = k - b * 3;
  float acc = 0.f;
  for (int tl = 0; tl < tiles; ++tl) acc += partial[(b * tiles + tl) * 3 + r];
  dangles[k] = acc;
}

// channels per tile when `buffers` (S, ct) tiles and `extra` floats share
// the 48 KB; 0 if not even one column fits
int tile_width(int L, int C, int buffers, int extra) {
  const int L1 = L + 1, S = L1 * L1;
  const size_t fixed = sizeof(float) * ((size_t)j_offset(L1) + 6 * L1 + extra);
  const size_t per_col = sizeof(float) * buffers * (size_t)S;
  if (fixed + per_col > kSmemLimit) return 0;
  const int ct = (int)((kSmemLimit - fixed) / per_col);
  return ct > C ? C : ct;
}

size_t smem_bytes(int L, int ct, int buffers, int extra) {
  const int L1 = L + 1, S = L1 * L1;
  return sizeof(float) * ((size_t)j_offset(L1) + 6 * L1 + extra
                          + (size_t)buffers * S * ct);
}

int launch_fwd(const void* angles, const void* x, const void* jpacked,
               void* out, void* y, void* z, int B, int L, int C,
               int per_sample, void* stream) {
  if (B < 0 || L < 0 || C <= 0) return 1;
  if (B == 0) return 0;
  const int ct = tile_width(L, C, 2, 0);
  if (ct == 0) return 1;
  const dim3 grid(B, (C + ct - 1) / ct);
  const size_t smem = smem_bytes(L, ct, 2, 0);
  const long long stride = per_sample ? (long long)(L + 1) * (L + 1) * C : 0;
  if (y != nullptr)
    wigner_chain_fwd_kernel<true><<<grid, kThreads, smem,
                                    (cudaStream_t)stream>>>(
        (const float*)angles, (const float*)x, (const float*)jpacked,
        (float*)out, (float*)y, (float*)z, L, C, ct, stride);
  else
    wigner_chain_fwd_kernel<false><<<grid, kThreads, smem,
                                     (cudaStream_t)stream>>>(
        (const float*)angles, (const float*)x, (const float*)jpacked,
        (float*)out, nullptr, nullptr, L, C, ct, stride);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError();
// 1 marks arguments the kernels do not take. per_sample is 0 for a
// spectrum x shared by the batch and 1 for a (B, S, C) one.

// out = W(angles) x
extern "C" int wigner_chain_fwd(const void* angles, const void* x,
                                const void* jpacked, void* out, int B, int L,
                                int C, int per_sample, void* stream) {
  return launch_fwd(angles, x, jpacked, out, nullptr, nullptr, B, L, C,
                    per_sample, stream);
}

// out, and the residuals y = J Z(g) x and z = J Z(b) y, (B, S, C) each
extern "C" int wigner_chain_fwd_res(const void* angles, const void* x,
                                    const void* jpacked, void* out, void* y,
                                    void* z, int B, int L, int C,
                                    int per_sample, void* stream) {
  if (y == nullptr || z == nullptr) return 1;
  return launch_fwd(angles, x, jpacked, out, y, z, B, L, C, per_sample,
                    stream);
}

// Channel tiles per sample of the backward, the size of its scratch's
// middle axis; 0 if the degree does not fit.
extern "C" int wigner_chain_bwd_tiles(int L, int C) {
  if (L < 0 || C <= 0) return 0;
  const int ct = tile_width(L, C, 5, 3 * kThreads);
  return ct == 0 ? 0 : (C + ct - 1) / ct;
}

// From the cotangent dout of out (B, S, C) and the residuals y, z: dx
// (B, S, C) per sample (skipped when dx is null) and dangles (B, 3).
// `partial` is scratch of (B, tiles, 3) floats, unused with one tile.
extern "C" int wigner_chain_bwd(const void* angles, const void* x,
                                const void* jpacked, const void* y,
                                const void* z, const void* dout, void* dx,
                                void* dangles, void* partial, int B, int L,
                                int C, int per_sample, void* stream) {
  if (B < 0 || L < 0 || C <= 0) return 1;
  if (B == 0) return 0;
  const int ct = tile_width(L, C, 5, 3 * kThreads);
  if (ct == 0) return 1;
  const int tiles = (C + ct - 1) / ct;
  if (tiles > 1 && partial == nullptr) return 1;
  const dim3 grid(B, tiles);
  const size_t smem = smem_bytes(L, ct, 5, 3 * kThreads);
  const long long stride = per_sample ? (long long)(L + 1) * (L + 1) * C : 0;
  cudaStream_t st = (cudaStream_t)stream;
  float* sums = tiles > 1 ? (float*)partial : (float*)dangles;
  wigner_chain_bwd_kernel<<<grid, kThreads, smem, st>>>(
      (const float*)angles, (const float*)x, (const float*)jpacked,
      (const float*)y, (const float*)z, (const float*)dout, (float*)dx, sums,
      L, C, ct, stride);
  if (tiles > 1) {
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    const int n = 3 * B;
    sum_tiles_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        sums, (float*)dangles, B, tiles);
  }
  return (int)cudaGetLastError();
}
