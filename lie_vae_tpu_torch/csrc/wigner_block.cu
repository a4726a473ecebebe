// The block-Wigner product out = W(angles) @ spec built per sample from its
// Fourier synthesis, forward and backward, for one NVIDIA Hopper card
// (sm_90a).
//
// Replaces the TPU kernels lie_vae_tpu/ops/kernels/wigner_block.py::
// _wigner_apply_kernel (forward: wigner_block_fwd) and ::_wigner_bwd_kernel
// (backward: wigner_block_bwd). Those keep four dense (2L+1, S, S)
// coefficient tensors C, C[rev,:], C[:,rev], C[rev,rev] resident in VMEM,
// synthesise four dense (S, S) factors per sample with scalar * matrix
// adds, and take one (S, S) x (S, C) MXU product; the batch is padded to
// the block size. The function and its contract carry over:
//
//   t (B, M) with M = 2L+1: [cos(0 b) .. cos(L b), sin(1 b) .. sin(L b)];
//   ca, sa, cg, sg (B, S): cos / sin(f alpha), cos / sin(f gamma) at the
//   row frequencies f, S = (L+1)^2; spec shared (S, C) or per-sample
//   (B, S, C); out (B, S, C); all float32.
//   d(beta) = sum_m t_m C_m, and with rev the reversal inside each degree
//   block,
//     W[s, e] = cg_e (ca_s d[s, e] + sa_s d[rev s, e])
//             - sg_e (ca_s d[s, rev e] + sa_s d[rev s, rev e]),
//   out = W spec, or W^T spec with `transpose`.
//
// What changes on a GPU. C_m is block-diagonal by degree, and inside degree
// block l only the frequencies m <= l are non-zero, so the kernel reads one
// packed tensor: for each degree l, its 2l+1 frequencies (cos 0..l, then
// sin 1..l) times the (2l+1)^2 block, sum_l (2l+1)^3 floats (4753 at L = 6,
// 19 KB, against 4 x 13 x 49 x 49 = 0.5 MB dense). The three reversed
// tensors are index reversals of the same values, read as such. The
// coefficients are read from global memory (they stay in L1/L2: every block
// reads the same 19 KB), so shared memory holds only per-sample state and
// no degree is refused for their size. Nothing outside the diagonal blocks
// of W, or of A = dL/dW, is formed.
//
// Forward design (first version: simple and right). One thread block per
// sample, any B >= 1, no padding. The block stages t, ca, sa, cg, sg in
// shared memory, synthesises the packed diagonal blocks of d, forms the
// blocks of W beside them, then each thread computes output elements
// (i, c) as the dot of row i of W (column i for W^T) with column c of the
// spectrum over the degree block of i. A shared spectrum is read by every
// block from the same addresses and stays in L2; it is never expanded.
//
// Backward. With A = dout spec^T (spec dout^T when transposed), restricted
// to the diagonal blocks:
//   dspec = W^T dout (W dout when transposed), per sample;
//   dca_s = sum_e A (cg d - sg d_col),
//   dsa_s = sum_e A (cg d_row - sg d_both),
//   dcg_e = sum_s A (ca d + sa d_row),
//   dsg_e = -sum_s A (ca d_col + sa d_both),
//   dt_m = sum H . C_m, H[p, q] = A[p, q] ca_p cg_q + A[rp, q] sa_rp cg_q
//          - A[p, rq] ca_p sg_rq - A[rp, rq] sa_rp sg_rq
// (H gathers the four <., C*_m> contractions of the TPU kernel into one
// against the unreversed coefficients). Row and column sums run in one
// thread each, in index order; each dt_m is a fixed-order warp shuffle tree
// and a sum over the warps in warp order: no atomics, so a run repeats bit
// for bit. dspec is per sample; for a shared spectrum the caller sums it
// over the batch.
//
// Shared memory: M + 4S + 2 n_j floats forward and M + 4S + 4 n_j + 4M
// backward, n_j = sum_l (2l+1)^2 (455 at L = 6): 8 KB and 15 KB at L = 6,
// 110 KB backward at L = 16, the tables' last degree, above the default
// 48 KB, so the launch raises the block's limit when it must.
//
// Bound on an H100 SXM: the bytes. Per sample the inputs t, ca, sa, cg, sg
// and the output are 4 (M + 4S + SC) B (and the spectrum, once if shared),
// plus the packed coefficients once; the float32 work is about
// 2 sum_l (2l+1)^3 for the synthesis, 8 n_j for W and 2 n_j C for the
// product per sample. At the training shape (B = 64, L = 6, C = 10) that is
// 0.2 MB and 1.9 MFLOP, 0.06 us: below one launch, so the launch and the
// dependent passes inside each block set the time.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;               // a multiple of 32
constexpr int kWarps = kThreads / 32;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;          // 227 KB, an H100 block's limit

// first packed index of the (2l+1)^2 block of degree l: sum_{k<l} (2k+1)^2
__device__ __host__ __forceinline__ int j_offset(int l) {
  return l * (4 * l * l - 1) / 3;
}

// first packed coefficient of degree l: sum_{k<l} (2k+1)^3 = l^2 (2 l^2 - 1)
__device__ __host__ __forceinline__ int c_offset(int l) {
  return l * l * (2 * l * l - 1);
}

__device__ __forceinline__ int degree_of_row(int i) {
  int l = 0;
  while ((l + 1) * (l + 1) <= i) ++l;
  return l;
}

__device__ __forceinline__ int degree_of_packed(int e) {
  int l = 0;
  while (j_offset(l + 1) <= e) ++l;
  return l;
}

// t, ca, sa, cg, sg of sample b into shared memory
__device__ __forceinline__ void load_sample(float* st, float* sca, float* ssa,
                                            float* scg, float* ssg,
                                            const float* t, const float* ca,
                                            const float* sa, const float* cg,
                                            const float* sg, long long b,
                                            int M, int S) {
  for (int k = threadIdx.x; k < M; k += blockDim.x) st[k] = t[b * M + k];
  for (int k = threadIdx.x; k < S; k += blockDim.x) {
    sca[k] = ca[b * S + k];
    ssa[k] = sa[b * S + k];
    scg[k] = cg[b * S + k];
    ssg[k] = sg[b * S + k];
  }
}

// packed diagonal blocks of d = sum_m t_m C_m
__device__ __forceinline__ void synthesize(float* d, const float* st,
                                           const float* __restrict__ coef,
                                           int L, int nj) {
  for (int e = threadIdx.x; e < nj; e += blockDim.x) {
    const int l = degree_of_packed(e), n = 2 * l + 1, nn = n * n;
    const float* cb = coef + c_offset(l) + (e - j_offset(l));
    float acc = 0.f;
    for (int m = 0; m <= l; ++m) acc = fmaf(st[m], __ldg(cb + m * nn), acc);
    for (int m = 1; m <= l; ++m)
      acc = fmaf(st[L + m], __ldg(cb + (l + m) * nn), acc);
    d[e] = acc;
  }
}

// packed diagonal blocks of W from those of d
__device__ __forceinline__ void form_w(float* w, const float* d,
                                       const float* sca, const float* ssa,
                                       const float* scg, const float* ssg,
                                       int nj) {
  for (int e = threadIdx.x; e < nj; e += blockDim.x) {
    const int l = degree_of_packed(e), n = 2 * l + 1, o = l * l;
    const int local = e - j_offset(l), a = local / n, c = local - a * n;
    const int ra = n - 1 - a, rc = n - 1 - c;
    const float* db = d + j_offset(l);
    const int s = o + a, col = o + c;
    w[e] = scg[col] * (sca[s] * db[a * n + c] + ssa[s] * db[ra * n + c])
         - ssg[col] * (sca[s] * db[a * n + rc] + ssa[s] * db[ra * n + rc]);
  }
}

// dst[b, i, c] = sum_k Wop[i, k] x[k, c] over the degree block of i, with
// Wop = W, or W^T when `transposed`
__device__ __forceinline__ void apply_w(float* __restrict__ dst,
                                        const float* w,
                                        const float* __restrict__ x, int S,
                                        int C, bool transposed) {
  for (int e = threadIdx.x; e < S * C; e += blockDim.x) {
    const int i = e / C, c = e - (e / C) * C;
    const int l = degree_of_row(i), n = 2 * l + 1, o = l * l, r = i - o;
    const float* wb = w + j_offset(l);
    float acc = 0.f;
    for (int k = 0; k < n; ++k) {
      const float wik = transposed ? wb[k * n + r] : wb[r * n + k];
      acc = fmaf(wik, x[(long long)(o + k) * C + c], acc);
    }
    dst[e] = acc;
  }
}

__global__ void wigner_block_fwd_kernel(
    const float* __restrict__ t, const float* __restrict__ ca,
    const float* __restrict__ sa, const float* __restrict__ cg,
    const float* __restrict__ sg, const float* __restrict__ spec,
    const float* __restrict__ coef, float* __restrict__ out, int L, int C,
    long long spec_stride, int transpose) {
  extern __shared__ float smem[];
  const int L1 = L + 1, S = L1 * L1, M = 2 * L + 1, nj = j_offset(L1);
  const long long b = blockIdx.x;
  float* st = smem;                 // M
  float* sca = st + M;              // S each
  float* ssa = sca + S;
  float* scg = ssa + S;
  float* ssg = scg + S;
  float* d = ssg + S;               // nj
  float* w = d + nj;                // nj

  load_sample(st, sca, ssa, scg, ssg, t, ca, sa, cg, sg, b, M, S);
  __syncthreads();
  synthesize(d, st, coef, L, nj);
  __syncthreads();
  form_w(w, d, sca, ssa, scg, ssg, nj);
  __syncthreads();
  apply_w(out + b * S * C, w, spec + b * spec_stride, S, C, transpose != 0);
}

__global__ void wigner_block_bwd_kernel(
    const float* __restrict__ t, const float* __restrict__ ca,
    const float* __restrict__ sa, const float* __restrict__ cg,
    const float* __restrict__ sg, const float* __restrict__ spec,
    const float* __restrict__ dout, const float* __restrict__ coef,
    float* __restrict__ dt, float* __restrict__ dca,
    float* __restrict__ dsa, float* __restrict__ dcg,
    float* __restrict__ dsg, float* __restrict__ dspec, int L, int C,
    long long spec_stride, int transpose) {
  extern __shared__ float smem[];
  const int L1 = L + 1, S = L1 * L1, M = 2 * L + 1, nj = j_offset(L1);
  const long long b = blockIdx.x;
  float* st = smem;                 // M
  float* sca = st + M;              // S each
  float* ssa = sca + S;
  float* scg = ssa + S;
  float* ssg = scg + S;
  float* d = ssg + S;               // nj each
  float* w = d + nj;
  float* A = w + nj;
  float* H = A + nj;
  float* red = H + nj;              // M * kWarps

  const float* x = spec + b * spec_stride;
  const float* g = dout + b * S * C;
  load_sample(st, sca, ssa, scg, ssg, t, ca, sa, cg, sg, b, M, S);
  __syncthreads();
  synthesize(d, st, coef, L, nj);
  // A = dout spec^T (spec dout^T when transposed) on the diagonal blocks
  for (int e = threadIdx.x; e < nj; e += blockDim.x) {
    const int l = degree_of_packed(e), n = 2 * l + 1, o = l * l;
    const int local = e - j_offset(l), a = local / n, c = local - a * n;
    const float* p = (transpose ? x : g) + (long long)(o + a) * C;
    const float* q = (transpose ? g : x) + (long long)(o + c) * C;
    float acc = 0.f;
    for (int k = 0; k < C; ++k) acc = fmaf(p[k], q[k], acc);
    A[e] = acc;
  }
  __syncthreads();
  form_w(w, d, sca, ssa, scg, ssg, nj);
  // H: the cotangent of d, one entry per packed element
  for (int e = threadIdx.x; e < nj; e += blockDim.x) {
    const int l = degree_of_packed(e), n = 2 * l + 1, o = l * l;
    const int local = e - j_offset(l), p = local / n, q = local - p * n;
    const int rp = n - 1 - p, rq = n - 1 - q;
    const float* Ab = A + j_offset(l);
    H[e] = Ab[p * n + q] * sca[o + p] * scg[o + q]
         + Ab[rp * n + q] * ssa[o + rp] * scg[o + q]
         - Ab[p * n + rq] * sca[o + p] * ssg[o + rq]
         - Ab[rp * n + rq] * ssa[o + rp] * ssg[o + rq];
  }
  // row sums (dca, dsa) and column sums (dcg, dsg), in index order
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    const int l = degree_of_row(i), n = 2 * l + 1, o = l * l, r = i - o;
    const int rr = n - 1 - r;
    const float* db = d + j_offset(l);
    const float* Ab = A + j_offset(l);
    float rca = 0.f, rsa = 0.f, rcg = 0.f, rsg = 0.f;
    for (int k = 0; k < n; ++k) {
      const int rk = n - 1 - k;
      // row i of A against columns k
      const float ar = Ab[r * n + k];
      rca += ar * (scg[o + k] * db[r * n + k] - ssg[o + k] * db[r * n + rk]);
      rsa += ar * (scg[o + k] * db[rr * n + k] - ssg[o + k] * db[rr * n + rk]);
      // column i of A against rows k
      const float ac = Ab[k * n + r];
      rcg += ac * (sca[o + k] * db[k * n + r] + ssa[o + k] * db[rk * n + r]);
      rsg -= ac * (sca[o + k] * db[k * n + rr] + ssa[o + k] * db[rk * n + rr]);
    }
    dca[b * S + i] = rca;
    dsa[b * S + i] = rsa;
    dcg[b * S + i] = rcg;
    dsg[b * S + i] = rsg;
  }
  __syncthreads();                  // w and H complete
  if (dspec != nullptr)
    apply_w(dspec + b * S * C, w, g, S, C, transpose == 0);

  // dt_m = sum_l <H_l, C_l,m>: a fixed-order tree per frequency
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;     // kWarps at launch
  for (int f = 0; f < M; ++f) {
    const int m = f <= L ? f : f - L;         // frequency of t_f
    float acc = 0.f;
    for (int e = threadIdx.x; e < nj; e += blockDim.x) {
      const int l = degree_of_packed(e);
      if (l < m) continue;
      const int n = 2 * l + 1;
      const int fl = f <= L ? m : l + m;       // its slot inside degree l
      acc = fmaf(H[e], __ldg(coef + c_offset(l) + fl * n * n
                             + (e - j_offset(l))), acc);
    }
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) red[f * nw + warp] = acc;
  }
  __syncthreads();
  for (int f = threadIdx.x; f < M; f += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < nw; ++k) acc += red[f * nw + k];
    dt[b * M + f] = acc;
  }
}

size_t fwd_smem(int L) {
  const int L1 = L + 1, S = L1 * L1, M = 2 * L + 1;
  return sizeof(float) * ((size_t)M + 4 * S + 2 * (size_t)j_offset(L1));
}

size_t bwd_smem(int L) {
  const int L1 = L + 1, S = L1 * L1, M = 2 * L + 1;
  return sizeof(float) * ((size_t)M + 4 * S + 4 * (size_t)j_offset(L1)
                          + (size_t)M * kWarps);
}

// allow `smem` bytes of dynamic shared memory for `kernel`; 1 if too many
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return 1;
  if (smem <= kDefaultSmem) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError();
// 1 marks arguments the kernels do not take. per_sample is 0 for a
// spectrum shared by the batch (S, C) and 1 for a (B, S, C) one; coef is
// the packed coefficient tensor described above.

// out = W spec (W^T spec with transpose)
extern "C" int wigner_block_fwd(const void* t, const void* ca,
                                const void* sa, const void* cg,
                                const void* sg, const void* spec,
                                const void* coef, void* out, int B, int L,
                                int C, int per_sample, int transpose,
                                void* stream) {
  if (B < 0 || L < 0 || C <= 0) return 1;
  if (B == 0) return 0;
  const size_t smem = fwd_smem(L);
  const int rc = allow_smem(wigner_block_fwd_kernel, smem);
  if (rc != 0) return rc;
  const long long stride = per_sample ? (long long)(L + 1) * (L + 1) * C : 0;
  wigner_block_fwd_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)t, (const float*)ca, (const float*)sa, (const float*)cg,
      (const float*)sg, (const float*)spec, (const float*)coef, (float*)out,
      L, C, stride, transpose);
  return (int)cudaGetLastError();
}

// From the cotangent dout (B, S, C): dt (B, M), dca, dsa, dcg, dsg (B, S)
// and dspec (B, S, C) per sample (skipped when dspec is null).
extern "C" int wigner_block_bwd(const void* t, const void* ca,
                                const void* sa, const void* cg,
                                const void* sg, const void* spec,
                                const void* dout, const void* coef, void* dt,
                                void* dca, void* dsa, void* dcg, void* dsg,
                                void* dspec, int B, int L, int C,
                                int per_sample, int transpose,
                                void* stream) {
  if (B < 0 || L < 0 || C <= 0) return 1;
  if (B == 0) return 0;
  const size_t smem = bwd_smem(L);
  const int rc = allow_smem(wigner_block_bwd_kernel, smem);
  if (rc != 0) return rc;
  const long long stride = per_sample ? (long long)(L + 1) * (L + 1) * C : 0;
  wigner_block_bwd_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)t, (const float*)ca, (const float*)sa, (const float*)cg,
      (const float*)sg, (const float*)spec, (const float*)dout,
      (const float*)coef, (float*)dt, (float*)dca, (float*)dsa, (float*)dcg,
      (float*)dsg, (float*)dspec, L, C, stride, transpose);
  return (int)cudaGetLastError();
}
