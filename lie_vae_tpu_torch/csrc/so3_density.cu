// Wrapped SO(3) pushforward log-density, the KL that averages it over the
// samples of each row, and their backward, for one NVIDIA Hopper card
// (sm_90a).
//
// Replaces the TPU kernels lie_vae_tpu/ops/kernels/so3_density.py::
// _density_kernel (forward) and ::_density_bwd_kernel (analytic backward).
// Those ride a transposed (3, N) layout so that samples fill the TPU's
// 128 lanes. What carries over is the arithmetic:
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
//   dsigma = g (Bw u^2 / sigma^3 - 1 / sigma), summed over the samples of
//   the row (the transpose of sigma's broadcast).
//
// Layout: v (N, 3) float32 with N = n * B samples, sample i = s * B + b;
// sigma (B, 3), read at row b (the broadcast over the n samples is an
// index, never a copy). Three entries:
//   so3_density_fwd  log q per sample, out (N,): the IW-LL's log-posterior;
//   so3_density_kl   kl[b] = mean_s log q(v[s, b]) + log 8 pi^2, (B,): the
//                    Monte-Carlo KL against the Haar prior, the mean and the
//                    prior folded in (what XLA fuses around the TPU kernel);
//   so3_density_bwd  dv (N, 3) and dsigma (B, 3), for a cotangent per
//                    sample (N,) or per row (B,), the latter the KL's (the
//                    kernel scales it by 1 / n); any stride.
//
// Bound on an H100 SXM: the bytes (v, sigma and the outputs, 28 B a sample
// at n = 1 forward and 52 B backward) over 3.35 TB/s, with the shells'
// operations (float32 forward over 67 TFLOP/s, float64 backward over 34)
// below them: under 2 ns at N = 64 and 34 / 64 ns at N = 4096, far below
// one launch. One sample is a serial chain (loads, reciprocals, 2k + 1
// exps, logs), so the kernel is bound by that chain's latency: a sample is
// taken by a group of G lanes of one warp (G in {1, 2, 4, 8}, chosen by the
// caller from N: wide groups while N leaves the card idle, G = 1 once the
// lanes' repeated per-sample work costs more than they save). Lane r takes
// shells t = r, r + G, ... (j = t - k), the lanes' partial sums meet in a
// fixed xor-shuffle tree (bit-identical on every lane), so for k = 10,
// G = 8 the chain holds three exps instead of 21. k = 10 (the flagship) is
// a template argument, so its shell loop unrolls; other k run a generic
// loop. m2 comes in closed form from the two shells around -theta / 2 pi
// (one of them is the nearest; the pair also holds both shells of a tie),
// through the same FMA as the shell loop, so it is the loop's minimum to
// the bit. The row sums (kl over s, dsigma over s) run in a fixed order:
// each slot of G lanes sums its samples s0, s0 + S, ... in turn, then the
// S slots of a row meet in a shared-memory tree. No atomics: a run repeats
// bit for bit. The backward runs in float64 but for the exps (see
// so3_density_bwd_kernel).
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr double kTwoPi = 6.28318530717958647692;
constexpr double kInvTwoPi = 0.15915494309189533577;
constexpr float kLog2Pi = 1.83787706640934548356f;
constexpr float kLogHaar = -4.36890131337863600f;  // -log(8 pi^2)

// the float and double spellings of what a sample needs. The reciprocals
// are branch-free (the IEEE ones check for special values and branch, which
// keeps the compiler from overlapping the shells that call them): float's
// to 2 ulp, double's from it by two Newton steps to double's precision, for
// |x| in [2^-126, 2^126].
__device__ __forceinline__ float rcp(float x) { return __fdividef(1.f, x); }
__device__ __forceinline__ double rcp(double x) {
  double y = (double)rcp((float)x);
  y = fma(y, fma(-x, y, 1.0), y);
  return fma(y, fma(-x, y, 1.0), y);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }
__device__ __forceinline__ float larger(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double larger(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float smaller(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ double smaller(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float down(float x) { return floorf(x); }
__device__ __forceinline__ double down(double x) { return floor(x); }

template <typename T>
struct Sample {
  T u[3], s[3], is[3];  // v / theta, sigma, 1 / sigma
  T theta, it, q, m2;   // |v|, 1 / max(|v|, 1e-12)
};

// th_j = 2 pi j + theta, rounded once, wherever a shell is formed
template <typename T>
__device__ __forceinline__ T shell(int j, T theta) {
  return fma_rn(T(kTwoPi), T(j), theta);
}

template <typename T>
__device__ __forceinline__ Sample<T> load(const float* __restrict__ v,
                                          const float* __restrict__ sigma,
                                          int i, int b, int k) {
  Sample<T> p;
  const T vc[3] = {T(__ldg(v + 3 * i)), T(__ldg(v + 3 * i + 1)),
                   T(__ldg(v + 3 * i + 2))};
  p.theta = root(vc[0] * vc[0] + vc[1] * vc[1] + vc[2] * vc[2]);
  p.it = rcp(larger(p.theta, T(1e-12)));
  p.q = T(0);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    p.s[c] = T(__ldg(sigma + 3 * b + c));
    p.is[c] = rcp(p.s[c]);
    p.u[c] = vc[c] * p.it;
    const T r = p.u[c] * p.is[c];
    p.q += r * r;
  }
  // the nearest shell is floor(-theta / 2 pi) or the one above it
  const T lo = smaller(larger(down(-p.theta * T(kInvTwoPi)), T(-k)), T(k));
  const T a = shell((int)lo, p.theta);
  const T c = shell(min((int)lo + 1, k), p.theta);
  p.m2 = smaller(a * a, c * c);
  return p;
}

// f(j) for this lane's shells j = t - k, t = r, r + G, ... < 2k + 1
template <int K, int G, typename F>
__device__ __forceinline__ void for_shells(int k, int r, F&& f) {
  if constexpr (K >= 0) {
    constexpr int kShells = 2 * K + 1;
#pragma unroll
    for (int t0 = 0; t0 < kShells; t0 += G)
      if (kShells % G == 0 || t0 + r < kShells) f(t0 + r - K);
  } else {
    for (int t = r; t < 2 * k + 1; t += G) f(t - k);
  }
}

// the G lanes' partial sums in a fixed xor tree: every lane gets the total
template <int G, typename T>
__device__ __forceinline__ T lane_sum(T x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, G);
  return x;
}

// sum_j max(th_j^2, clamp) exp(-q (th_j^2 - m2) / 2) over all shells
template <int K, int G>
__device__ __forceinline__ float shell_sum(const Sample<float>& p, int k,
                                           int r, float clamp) {
  float e = 0.f;
  for_shells<K, G>(k, r, [&](int j) {
    const float th = shell(j, p.theta), th2 = th * th;
    e += fmaxf(th2, clamp) * expf(-0.5f * p.q * (th2 - p.m2));
  });
  return lane_sum<G>(e);
}

// log q less log E: formed before the shells, so that only log E is left
// after the lanes' tree
__device__ __forceinline__ float log_q_rest(const Sample<float>& p,
                                            float clamp) {
  const float denom = fmaxf(2.f - 2.f * cosf(p.theta), clamp);
  const float log_norm = logf(p.s[0]) + logf(p.s[1]) + logf(p.s[2]);
  return -0.5f * p.q * p.m2 - logf(denom) - log_norm - 1.5f * kLog2Pi;
}

// The n samples of each row: a block holds kThreads / G slots of G lanes,
// S = 1 << log2S slots a row (S <= n rounded up to a power of two), so
// kThreads / G / S rows a block.
struct Rows {
  int r, slot, s0, b;
  bool live;
  __device__ __forceinline__ Rows(int G, int log2S, int B) {
    r = threadIdx.x % G;
    slot = threadIdx.x / G;
    s0 = slot & ((1 << log2S) - 1);
    b = blockIdx.x * ((kThreads / G) >> log2S) + (slot >> log2S);
    live = b < B;
  }
};

// the S slots of a row summed in a fixed tree in shared memory; returns
// the row's total on the lanes of its slot s0 = 0
template <typename T, int M>
__device__ __forceinline__ void row_sum(T (&part)[M][kThreads], T (&x)[M],
                                        const Rows& w, int log2S) {
  if (log2S == 0) return;
  if (w.r == 0)
#pragma unroll
    for (int m = 0; m < M; ++m) part[m][w.slot] = x[m];
  for (int off = (1 << log2S) >> 1; off > 0; off >>= 1) {
    __syncthreads();
    if (w.r == 0 && w.s0 < off)
#pragma unroll
      for (int m = 0; m < M; ++m) part[m][w.slot] += part[m][w.slot + off];
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < M; ++m) x[m] = part[m][w.slot];
}

template <int K, int G>
__global__ void __launch_bounds__(kThreads)
    so3_density_fwd_kernel(const float* __restrict__ v,
                           const float* __restrict__ sigma,
                           float* __restrict__ out, int N, int B, int k,
                           float clamp) {
  const int r = threadIdx.x % G;
  const int i = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  // a group past the end computes sample N - 1 and stores nothing: every
  // lane of the warp takes part in the shuffles
  const int ii = i < N ? i : N - 1;
  const Sample<float> p =
      load<float>(v, sigma, ii, (int)((unsigned)ii % (unsigned)B), k);
  const float rest = log_q_rest(p, clamp);
  const float E = shell_sum<K, G>(p, k, r, clamp);
  if (i < N && r == 0) out[i] = logf(E) + rest;
}

template <int K, int G>
__global__ void __launch_bounds__(kThreads)
    so3_density_kl_kernel(const float* __restrict__ v,
                          const float* __restrict__ sigma,
                          float* __restrict__ kl, int n, int B, int k,
                          int log2S, float inv_n, float clamp) {
  __shared__ float part[1][kThreads];
  const Rows w(G, log2S, B);
  const int b = w.live ? w.b : 0;
  float acc[1] = {0.f};
  const int trips = (n + (1 << log2S) - 1) >> log2S;
  for (int t = 0; t < trips; ++t) {
    const int s = w.s0 + (t << log2S);
    const bool valid = w.live && s < n;
    const Sample<float> p =
        load<float>(v, sigma, valid ? s * B + b : b, b, k);
    const float rest = log_q_rest(p, clamp);
    const float E = shell_sum<K, G>(p, k, w.r, clamp);
    if (valid) acc[0] += logf(E) + rest;
  }
  row_sum(part, acc, w, log2S);
  if (w.live && w.r == 0 && w.s0 == 0) kl[w.b] = acc[0] * inv_n - kLogHaar;
}

// K4 works in double, but for each shell's exp (expf of the double
// exponent): dsigma = g (Bw u^2 / sigma^3 - 1 / sigma) cancels two terms of
// order 1 / sigma, and where one sigma_c is small and the others large the
// float32 sums behind Bw alone lose more than the 1e-3 the gradient is held
// to. The card's double units run at half the float rate, and a sample has
// only its few shells a lane.
template <int K, int G, bool kRowG>
__global__ void __launch_bounds__(kThreads)
    so3_density_bwd_kernel(const float* __restrict__ v,
                           const float* __restrict__ sigma,
                           const float* __restrict__ g, int g_stride,
                           float* __restrict__ dv,
                           float* __restrict__ dsigma, int n, int B, int k,
                           int log2S, double inv_n, float clamp) {
  __shared__ double part[3][kThreads];
  const Rows w(G, log2S, B);
  const int b = w.live ? w.b : 0;
  double ds[3] = {0.0, 0.0, 0.0};
  const double g_row =
      kRowG ? __ldg(g + (long long)b * g_stride) * inv_n : 0.0;
  const int trips = (n + (1 << log2S) - 1) >> log2S;
  for (int t = 0; t < trips; ++t) {
    const int s = w.s0 + (t << log2S);
    const bool valid = w.live && s < n;
    const int i = valid ? s * B + b : b;
    const Sample<double> p = load<double>(v, sigma, i, b, k);
    // the volume term's derivative, before the shells (off the tail)
    double sn, cs;
    sincos(p.theta, &sn, &cs);
    // (both sides of each kill-switch are formed and one is selected: a
    // branch in the shell loop would keep its shells from overlapping)
    const double den = 2.0 - 2.0 * cs;
    const double vol = 2.0 * sn * rcp(den);
    const double dvol = den > clamp ? vol : 0.0;
    const double nhq = -0.5 * p.q;
    double se = 0.0, sa = 0.0, sb = 0.0;
    for_shells<K, G>(k, w.r, [&](int j) {
      const double th = shell(j, p.theta), th2 = th * th;
      const double e = fmax(th2, (double)clamp)
                       * (double)expf((float)(nhq * (th2 - p.m2)));
      const double inv = 2.0 * (double)rcp((float)th);
      se += e;
      sa += e * fma_rn(-p.q, th, th2 > clamp ? inv : 0.0);
      sb += e * th2;
    });
    se = lane_sum<G>(se);
    sa = lane_sum<G>(sa);
    sb = lane_sum<G>(sb);
    if (valid) {
      const double ise = rcp(se);
      const double A = sa * ise - dvol;
      const double Bw = sb * ise, Bt = Bw * p.it;
      const double gi = kRowG ? g_row : __ldg(g + (long long)i * g_stride);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const double u = p.u[c], is = p.is[c], r = u * is;
        if (w.r == 0)
          dv[3 * i + c] = (float)(gi * (A * u - Bt * (r * is - p.q * u)));
        ds[c] += gi * is * (Bw * r * r - 1.0);
      }
    }
  }
  row_sum(part, ds, w, log2S);
  if (w.live && w.r == 0 && w.s0 == 0)
#pragma unroll
    for (int c = 0; c < 3; ++c) dsigma[3 * w.b + c] = (float)ds[c];
}

template <int V>
using Int = std::integral_constant<int, V>;

// f(K, G) with K = 10 or the generic -1, and G = lanes
template <typename F>
int dispatch(int k, int lanes, F&& f) {
  auto by_lanes = [&](auto K) -> int {
    switch (lanes) {
      case 1: return f(K, Int<1>{});
      case 2: return f(K, Int<2>{});
      case 4: return f(K, Int<4>{});
      case 8: return f(K, Int<8>{});
    }
    return 1;
  };
  return k == 10 ? by_lanes(Int<10>{}) : by_lanes(Int<-1>{});
}

// slots a row: n rounded up to a power of two, at most a block's slots
int log2_slots(int n, int lanes) {
  int log2S = 0;
  while ((1 << log2S) < n && (2 << log2S) <= kThreads / lanes) ++log2S;
  return log2S;
}

// N samples in all: every index, and N plus a block, stays in 32 bits
bool bad(long long N, int B, int k) {
  return N < 0 || B <= 0 || k < 0 || N >= (1LL << 31) - kThreads;
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError(); 1 marks
// arguments the kernels do not take (lanes outside {1, 2, 4, 8}).
extern "C" int so3_density_fwd(const void* v, const void* sigma, void* out,
                               int N, int B, int k, int lanes, float clamp,
                               void* stream) {
  if (bad(N, B, k) || N % B != 0) return 1;
  if (N == 0) return 0;
  return dispatch(k, lanes, [&](auto K, auto G) {
    constexpr int kG = decltype(G)::value;
    const int per_block = kThreads / kG;
    so3_density_fwd_kernel<decltype(K)::value, kG>
        <<<(N + per_block - 1) / per_block, kThreads, 0,
           (cudaStream_t)stream>>>((const float*)v, (const float*)sigma,
                                   (float*)out, N, B, k, clamp);
    return (int)cudaGetLastError();
  });
}

extern "C" int so3_density_kl(const void* v, const void* sigma, void* kl,
                              int n, int B, int k, int lanes, float clamp,
                              void* stream) {
  if (bad((long long)n * B, B, k) || n <= 0) return 1;
  return dispatch(k, lanes, [&](auto K, auto G) {
    constexpr int kG = decltype(G)::value;
    const int log2S = log2_slots(n, kG);
    const int rows = (kThreads / kG) >> log2S;
    so3_density_kl_kernel<decltype(K)::value, kG>
        <<<(B + rows - 1) / rows, kThreads, 0, (cudaStream_t)stream>>>(
            (const float*)v, (const float*)sigma, (float*)kl, n, B, k, log2S,
            1.f / (float)n, clamp);
    return (int)cudaGetLastError();
  });
}

extern "C" int so3_density_bwd(const void* v, const void* sigma,
                               const void* g, int g_stride, int row_g,
                               void* dv, void* dsigma, int n, int B, int k,
                               int lanes, float clamp, void* stream) {
  if (bad((long long)n * B, B, k) || n <= 0 || g_stride < 0) return 1;
  return dispatch(k, lanes, [&](auto K, auto G) {
    constexpr int kK = decltype(K)::value, kG = decltype(G)::value;
    const int log2S = log2_slots(n, kG);
    const int rows = (kThreads / kG) >> log2S;
    const dim3 grid((B + rows - 1) / rows);
    const auto launch = row_g ? so3_density_bwd_kernel<kK, kG, true>
                              : so3_density_bwd_kernel<kK, kG, false>;
    launch<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)v, (const float*)sigma, (const float*)g, g_stride,
        (float*)dv, (float*)dsigma, n, B, k, log2S, 1.0 / n, clamp);
    return (int)cudaGetLastError();
  });
}
