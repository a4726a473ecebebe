// Wrapped SO(3) pushforward log-density and its backward, for one NVIDIA
// Hopper card (sm_90a).
//
// Replaces the TPU kernels lie_vae_tpu/ops/kernels/so3_density.py::
// _density_kernel (forward) and ::_density_bwd_kernel (analytic backward).
// Those ride a transposed (3, N) layout so that samples fill the TPU's
// 128 lanes; a GPU thread reads the (N, 3) rows as they are, so there is
// no transpose and no padding. What carries over is the arithmetic:
//
//   theta = |v|, u = v / max(theta, 1e-12), q = sum_c (u_c / sigma_c)^2,
//   shells th_j = theta + 2 pi j, j in [-k, k];
//   log q(v) = log sum_j max(th_j^2, clamp) exp(-q (th_j^2 - m2) / 2)
//              - q m2 / 2 - log max(2 - 2 cos theta, clamp)
//              - sum_c log sigma_c - (3/2) log 2 pi,
//   m2 = min_j th_j^2 (the max-shift: every exponent <= 0, and the sum is at
//   least the clamped m2 term, so nothing over- or underflows). The volume
//   denominator is the same for every shell (cos(theta + 2 pi j) =
//   cos theta), so it leaves the sum: one exp per shell.
//
//   Backward, with w_j = softmax_j of the shell terms,
//   A = sum_j w_j (-q th_j + [th_j^2 > clamp] 2 / th_j)
//       - [2 - 2 cos theta > clamp] 2 sin theta / (2 - 2 cos theta),
//   Bw = sum_j w_j th_j^2:
//   dv = g (A u - (Bw / max(theta, 1e-12)) (u / sigma^2 - q u)),
//   dsigma = g (Bw u^2 / sigma^3 - 1 / sigma).
//
// Layout: v (N, 3) float32 with N = n * B samples, sample i = s * B + b;
// sigma (B, 3) float32, read at row i % B (the broadcast over the n
// samples is an index, never a copy); out (N,), dv (N, 3), dsigma (N, 3)
// per sample (the caller sums dsigma over n, the transpose of the
// broadcast). One thread per sample, shells in a loop.
//
// Bound on an H100 SXM: the bytes, 28 B per sample forward (v, sigma, out)
// and 52 B backward (v, sigma, g, dv, dsigma), over 3.35 TB/s; the shell
// loop's float32 operations (about 15 per shell) over 67 TFLOP/s come
// below that. At the training shape (N = B = 64) that is under 2 ns, far
// below one launch, so the launch is the cost; at N = B = 4096 it is 34 ns
// forward and 64 ns backward, still below a launch.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kLog2Pi = 1.83787706640934548356f;

struct Sample {
  float u[3], s[3];
  float theta, theta_s, q, m2;
};

__device__ __forceinline__ Sample load(const float* __restrict__ v,
                                       const float* __restrict__ sigma,
                                       long long i, int B, int k) {
  Sample p;
  const float* vi = v + 3 * i;
  const float* si = sigma + 3 * (i % B);
  const float v0 = vi[0], v1 = vi[1], v2 = vi[2];
  p.theta = sqrtf(v0 * v0 + v1 * v1 + v2 * v2);
  p.theta_s = fmaxf(p.theta, 1e-12f);
  p.u[0] = v0 / p.theta_s;
  p.u[1] = v1 / p.theta_s;
  p.u[2] = v2 / p.theta_s;
  p.q = 0.f;
  for (int c = 0; c < 3; ++c) {
    p.s[c] = si[c];
    const float r = p.u[c] / p.s[c];
    p.q += r * r;
  }
  p.m2 = INFINITY;
  for (int j = -k; j <= k; ++j) {
    const float th = kTwoPi * (float)j + p.theta;
    p.m2 = fminf(p.m2, th * th);
  }
  return p;
}

__global__ void so3_density_fwd_kernel(const float* __restrict__ v,
                                       const float* __restrict__ sigma,
                                       float* __restrict__ out, long long N,
                                       int B, int k, float clamp) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const Sample p = load(v, sigma, i, B, k);
  float E = 0.f;
  for (int j = -k; j <= k; ++j) {
    const float th = kTwoPi * (float)j + p.theta;
    const float th2 = th * th;
    E += fmaxf(th2, clamp) * expf(-0.5f * p.q * (th2 - p.m2));
  }
  const float denom = fmaxf(2.f - 2.f * cosf(p.theta), clamp);
  const float log_norm = logf(p.s[0]) + logf(p.s[1]) + logf(p.s[2]);
  out[i] = logf(E) - 0.5f * p.q * p.m2 - logf(denom) - log_norm
           - 1.5f * kLog2Pi;
}

__global__ void so3_density_bwd_kernel(const float* __restrict__ v,
                                       const float* __restrict__ sigma,
                                       const float* __restrict__ g,
                                       float* __restrict__ dv,
                                       float* __restrict__ dsigma,
                                       long long N, int B, int k,
                                       float clamp) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const Sample p = load(v, sigma, i, B, k);
  float sum_e = 0.f, sum_a = 0.f, sum_b = 0.f;
  for (int j = -k; j <= k; ++j) {
    const float th = kTwoPi * (float)j + p.theta;
    const float th2 = th * th;
    const float e = fmaxf(th2, clamp) * expf(-0.5f * p.q * (th2 - p.m2));
    sum_e += e;
    sum_a += e * (-p.q * th + (th2 > clamp ? 2.f / th : 0.f));
    sum_b += e * th2;
  }
  const float denom = 2.f - 2.f * cosf(p.theta);
  const float A = sum_a / sum_e
      - (denom > clamp ? 2.f * sinf(p.theta) / fmaxf(denom, clamp) : 0.f);
  const float Bw = sum_b / sum_e;
  const float gi = g[i];
  for (int c = 0; c < 3; ++c) {
    const float u = p.u[c], s = p.s[c], s2 = s * s;
    dv[3 * i + c] = gi * (A * u - (Bw / p.theta_s) * (u / s2 - p.q * u));
    dsigma[3 * i + c] = gi * (Bw * (u * u) / (s2 * s) - 1.f / s);
  }
}

int grid_of(long long N) { return (int)((N + kThreads - 1) / kThreads); }

}  // namespace

// Each launches on `stream` and returns cudaGetLastError(); 1 marks
// arguments the kernel does not take.
extern "C" int so3_density_fwd(const void* v, const void* sigma, void* out,
                               long long N, int B, int k, float clamp,
                               void* stream) {
  if (N < 0 || B <= 0 || k < 0 || N % B != 0 || N / kThreads >= (1LL << 31))
    return 1;
  if (N == 0) return 0;
  so3_density_fwd_kernel<<<grid_of(N), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)v, (const float*)sigma, (float*)out, N, B, k, clamp);
  return (int)cudaGetLastError();
}

extern "C" int so3_density_bwd(const void* v, const void* sigma,
                               const void* g, void* dv, void* dsigma,
                               long long N, int B, int k, float clamp,
                               void* stream) {
  if (N < 0 || B <= 0 || k < 0 || N % B != 0 || N / kThreads >= (1LL << 31))
    return 1;
  if (N == 0) return 0;
  so3_density_bwd_kernel<<<grid_of(N), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)v, (const float*)sigma, (const float*)g, (float*)dv,
      (float*)dsigma, N, B, k, clamp);
  return (int)cudaGetLastError();
}
