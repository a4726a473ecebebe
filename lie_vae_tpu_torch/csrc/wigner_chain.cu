// Forward block-Wigner chain out = Z(a) J Z(b) J Z(g) x on a real
// direct-sum spectrum, for one NVIDIA Hopper card (sm_90a).
//
// Replaces the TPU kernel lie_vae_tpu/ops/kernels/wigner_fused.py::
// _chain_kernel (run without residuals through _plain_kernel). That kernel
// rides a flat (B, S*C) lane layout with Kronecker-expanded (SC, SC)
// constants, 0/+-1 selection products for the trig features and an
// x[rev] gather done outside the kernel: all ways around the TPU's lack of
// lane gathers. A GPU gathers from shared memory, so none of that carries
// over; the function and its contract do:
//
//   angles (B, 3) float32, ZYZ (a, b, g);
//   x shared (S, C) or per-sample (B, S, C) float32, S = (L+1)^2;
//   out (B, S, C) float32.
//   (Z(t) h)_i = cos(f_i t) h_i + sin(f_i t) h_rev(i), with f_i = l - (i - l^2)
//   for row i in degree block l and rev(i) = l^2 + (l^2 + 2l - i);
//   J = diag(J_0 .. J_L), packed row-major block after block (455 floats
//   for L = 6). W^T is the same chain at (-g, -b, -a): the caller flips the
//   angles, so this file has one entry point.
//
// Design (first version: simple and right). One thread block takes one
// sample and a tile of its channels; channels are independent columns of
// the chain, so the tile is sized to keep shared memory under the default
// 48 KB for every L the tables hold (L <= 16) and any C. The block stages
// the spectrum tile and J in shared memory, computes the 6(L+1) distinct
// sincosf(m t) once, then runs the chain in three passes, each fusing a
// z-rotation into the neighbouring J product:
//   y = J Z(g) x,   z = J Z(b) y,   out = Z(a) z.
// A shared (S, C) spectrum is read by every block from the same addresses
// and stays in L2; it is never expanded to (B, S, C).
//
// All arithmetic is float32. The JAX package computes its products in
// bfloat16 by default, a choice made for the TPU's matrix unit; this kernel
// does not copy it.
//
// Bound on an H100 SXM: the bytes, 12 B of angles plus 4*S*C B of output
// per sample (plus the spectrum, once if shared), over 3.35 TB/s. At the
// serving shape (B = 64, L = 6, C = 10) that is about 130 KB, some 40 ns:
// far below one launch. At that shape the cost is the launch and the
// latency of the three dependent passes inside each block, not the bytes;
// a later version gains by shortening the passes (per-row index tables,
// more samples per block) and by fusing the kernel with its neighbours.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
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

// (Z(t) h)[i, c] read from a tile h of `ct` columns; trig holds cos(m t)
// at [m] and sin(m t) at [L1 + m].
__device__ __forceinline__ float zrot(const float* h, const float* trig,
                                      int L1, int i, int l, int c, int ct) {
  const int f = l - (i - l * l);
  const int m = f < 0 ? -f : f;
  const float s = f < 0 ? -trig[L1 + m] : trig[L1 + m];
  const int r = 2 * l * l + 2 * l - i;
  return trig[m] * h[i * ct + c] + s * h[r * ct + c];
}

// dst[i, c] = sum_j J_l[i, j] (Z(t) src)[j, c] over row i's block l
__device__ __forceinline__ void j_of_z(float* dst, const float* src,
                                       const float* jp, const float* trig,
                                       int L1, int S, int ct) {
  for (int e = threadIdx.x; e < S * ct; e += blockDim.x) {
    const int i = e / ct, c = e - (e / ct) * ct;
    const int l = degree_of(i), o = l * l, d = 2 * l + 1;
    const float* jrow = jp + j_offset(l) + (i - o) * d;
    float acc = 0.f;
    for (int k = 0; k < d; ++k)
      acc = fmaf(jrow[k], zrot(src, trig, L1, o + k, l, c, ct), acc);
    dst[e] = acc;
  }
}

__global__ void wigner_chain_fwd_kernel(const float* __restrict__ angles,
                                        const float* __restrict__ x,
                                        const float* __restrict__ jpacked,
                                        float* __restrict__ out,
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

  for (int k = threadIdx.x; k < n_j; k += blockDim.x) jp[k] = jpacked[k];
  for (int k = threadIdx.x; k < 3 * L1; k += blockDim.x) {
    const int slot = k / L1, m = k - slot * L1;
    float s, c;
    sincosf((float)m * angles[3 * (long long)b + slot], &s, &c);
    trig[2 * slot * L1 + m] = c;
    trig[2 * slot * L1 + L1 + m] = s;
  }
  const float* xb = x + (long long)b * x_batch_stride;
  for (int e = threadIdx.x; e < S * ct; e += blockDim.x) {
    const int i = e / ct, c = e - (e / ct) * ct;
    buf0[e] = c < cw ? xb[(long long)i * C + c0 + c] : 0.f;
  }
  __syncthreads();

  const float* ta = trig;
  const float* tb = trig + 2 * L1;
  const float* tg = trig + 4 * L1;
  j_of_z(buf1, buf0, jp, tg, L1, S, ct);     // y = J Z(g) x
  __syncthreads();
  j_of_z(buf0, buf1, jp, tb, L1, S, ct);     // z = J Z(b) y
  __syncthreads();

  float* ob = out + (long long)b * S * C;
  for (int e = threadIdx.x; e < S * ct; e += blockDim.x) {
    const int i = e / ct, c = e - (e / ct) * ct;
    if (c < cw)
      ob[(long long)i * C + c0 + c] =
          zrot(buf0, ta, L1, i, degree_of(i), c, ct);   // Z(a) z
  }
}

}  // namespace

// Launches the chain on `stream` and returns cudaGetLastError(); 1 marks
// arguments the kernel does not take. x_batch_stride is 0 for a spectrum
// shared by the batch and S*C for a per-sample one.
extern "C" int wigner_chain_fwd(const void* angles, const void* x,
                                const void* jpacked, void* out, int B, int L,
                                int C, int per_sample, void* stream) {
  if (B < 0 || L < 0 || C <= 0) return 1;
  if (B == 0) return 0;
  const int L1 = L + 1, S = L1 * L1;
  const size_t fixed = sizeof(float) * ((size_t)j_offset(L1) + 6 * L1);
  const size_t per_col = sizeof(float) * 2 * (size_t)S;
  if (fixed + per_col > kSmemLimit) return 1;
  int ct = (int)((kSmemLimit - fixed) / per_col);
  if (ct > C) ct = C;
  const dim3 grid(B, (C + ct - 1) / ct);
  const size_t smem = fixed + per_col * ct;
  wigner_chain_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)angles, (const float*)x, (const float*)jpacked,
      (float*)out, L, C, ct, per_sample ? (long long)S * C : 0LL);
  return (int)cudaGetLastError();
}
