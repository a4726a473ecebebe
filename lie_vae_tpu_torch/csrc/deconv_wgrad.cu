// The weight gradient of a k4 s2 p1 transposed convolution (the decoder's
// hidden DeconvNet layers), float32, for one NVIDIA Hopper card (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the transposed convs to
// XLA (its `fast_head` is a phase decomposition, not a Pallas kernel).
// Added because cuDNN runs this pass in IEEE float32 at 17-21 TFLOP/s on
// the flagship's 200-channel layers at 512 images (wgrad_alg0_engine, NCHW
// and NHWC; its stride-1 sub-pixel form goes to FFT; compare_deconv), the
// largest single cost of the training step.
//
//   dw[ci, co, kh, kw] = sum_{b, ih, iw} x[b, ci, ih, iw]
//                        * dy[b, co, 2 ih - 1 + kh, 2 iw - 1 + kw]
//
// with dy zero outside [0, 2H) x [0, 2W). An implicit GEMM of M = C_in,
// N = C_out x 16 taps, K = B H W: the sub-pixel form read the other way
// round. Output phase (r, s) of the transposed conv is a stride-1 2x2 conv
// whose taps are kh = 1, 3 (r = 0) or 0, 2 (r = 1), and likewise kw; a
// thread holds all four phases' taps of its (ci, co) pairs, so that each
// input position meets the 4x4 window of dy around output (2 ih, 2 iw)
// once, and every byte of dy and x is staged once per tile.
//
// Layout: x (B, C_in, H, W) and dy (B, C_out, 2H, 2W) contiguous NCHW
// float32; dw (C_in, C_out, 4, 4), the ConvTranspose2d weight's layout.
//
// Design. A block of 256 threads owns a tile of 40 input by 25 output
// channels (250 threads compute, 4 ci by 1 co by 16 taps each: 64 sums in
// registers) and a contiguous range of chunks of K. A chunk is R input
// rows of one image (R W = 64 positions but at W = 4, whose images are 16):
// the block stages the chunk's x (40 channels x R W positions, channels
// fastest) and the dy rows 2 ih0 - 1 .. 2 ih0 + 2R around it (25 channels
// x (2R + 2) rows x (2W + 2) columns, zero-padded by one column each side)
// in shared memory by cp.async (zero fill where a row, column or channel
// falls outside), two buffers deep, so the next chunk's copies run under
// this chunk's sums. A thread walks each row's W positions with a 4x4
// window of dy in registers: a step loads its 4 x channels (one 16-byte
// load) and the window's two new columns (four 8-byte loads) and issues 64
// FMAs. The block's partial sums go to a workspace (S, C_in, C_out, 16);
// a second kernel sums the S splits in a fixed order, so a run repeats bit
// for bit (no atomics). S is chosen so the grid fills whole waves of the
// card's resident blocks.
//
// Bound on an H100 SXM: operations, 2 C_in C_out 16 B H W (167.8 GFLOP
// for the flagship's deconv.7 at 512 images, 2.50 ms at 67 TFLOP/s); the
// bytes (x and dy once, 0.52 GB, 0.16 ms at 3.35 TB/s) are well below, and
// the tile's staging reads each from L2 C_out / 25 or C_in / 40 times.
// Measured (compare_deconv, 512 images): 5.7-5.8 ms at deconv.7, 43-44% of
// the float32 peak, where cuDNN's wgrad takes 9.9 ms. What limits it is
// the rate at which the SM takes these FMAs: variants that dropped the
// staging, dropped the window's loads, unrolled less, changed the loop
// order or took 8 ci a thread all timed the same, to the microsecond.
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCiT = 40;   // input channels a block
constexpr int kCoT = 25;   // output channels a block
constexpr int kCompute = (kCiT / 4) * kCoT;   // 250 threads hold sums
constexpr int kXP = kCiT + 4;   // a position's stride in x's tile (16 B)

template <int W, int R>
struct Tile {
  static constexpr int kRows = 2 * R + 2;        // dy rows a chunk
  static constexpr int kCols = 2 * W + 2;        // dy columns, padded
  static constexpr int kRC = kRows * kCols;
  // a channel's stride, 2 mod 4 floats: 8-byte loads of consecutive
  // channels fall on distinct bank pairs
  static constexpr int kCoS = kRC % 4 == 0 ? kRC + 2 : kRC;
  // floats, rounded up to 16 bytes so x's tile after it is aligned
  static constexpr int kDy = (kCoT * kCoS + 3) / 4 * 4;
  static constexpr int kX = R * W * kXP;         // floats
  static constexpr int kStage = kDy + kX;
  static constexpr int kBytes = 2 * kStage * 4;  // two buffers
};

// cp.async of 4 bytes, zero-filled when not `valid` (src is then any
// readable address); the plain copy where no device code is compiled (a
// host-side rehearsal of the kernel)
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
#else
  *dst = valid ? *src : 0.f;
#endif
}
__device__ __forceinline__ void copy_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}
template <int N>
__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// Stage chunk `c` (image c / per_img, rows (c % per_img) R ..) of the
// block's tile into `buf`.
template <int W, int R>
__device__ __forceinline__ void stage(float* buf, const float* x,
                                      const float* dy, int c, int per_img,
                                      int ci0, int co0, int Ci, int Co,
                                      int H) {
  using T = Tile<W, R>;
  const int b = c / per_img, ih0 = (c % per_img) * R;
  const int t = threadIdx.x;
  float* dys = buf;
  float* xs = buf + T::kDy;
  const long long H2 = 2LL * H, W2 = 2 * W;
  const float* dyb = dy + ((long long)b * Co + co0) * H2 * W2;
  for (int e = t; e < kCoT * T::kRC; e += kThreads) {
    const int ch = e / T::kRC, rem = e - ch * T::kRC;
    const int row = rem / T::kCols, col = rem - row * T::kCols;
    const int gr = 2 * ih0 - 1 + row, gc = col - 1;
    const bool ok = co0 + ch < Co && gr >= 0 && gr < H2 && gc >= 0 &&
                    gc < W2;
    copy4(dys + ch * T::kCoS + row * T::kCols + col,
          ok ? dyb + (ch * H2 + gr) * W2 + gc : dy, ok);
  }
  const float* xb = x + ((long long)b * Ci + ci0) * H * W + ih0 * W;
  for (int e = t; e < kCiT * R * W; e += kThreads) {
    const int ch = e / (R * W), p = e - ch * (R * W);
    const bool ok = ci0 + ch < Ci && ih0 + p / W < H;
    copy4(xs + p * kXP + ch, ok ? xb + (long long)ch * H * W + p : x, ok);
  }
}

template <int W, int R>
__global__ void __launch_bounds__(kThreads, 2)
deconv_wgrad_kernel(const float* __restrict__ x,
                    const float* __restrict__ dy, float* __restrict__ ws,
                    int B, int Ci, int Co, int H, int splits) {
  using T = Tile<W, R>;
  extern __shared__ __align__(16) float smem[];
  const int co0 = blockIdx.x * kCoT, ci0 = blockIdx.y * kCiT;
  const int split = blockIdx.z;
  const int per_img = (H + R - 1) / R;
  const long long chunks = (long long)B * per_img;
  const int c_lo = (int)(chunks * split / splits);
  const int c_hi = (int)(chunks * (split + 1) / splits);
  const int t = threadIdx.x;
  const int co_l = t % kCoT, cg = t / kCoT;   // cg < 10 computes

  float acc[4][4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[c][i][j] = 0.f;

  if (c_lo < c_hi)
    stage<W, R>(smem, x, dy, c_lo, per_img, ci0, co0, Ci, Co, H);
  copy_commit();
  for (int c = c_lo; c < c_hi; ++c) {
    const int cur = (c - c_lo) & 1;
    if (c + 1 < c_hi) {
      stage<W, R>(smem + (cur ^ 1) * T::kStage, x, dy, c + 1, per_img, ci0,
                  co0, Ci, Co, H);
      copy_commit();
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();
    if (t < kCompute) {
      const float* dys = smem + cur * T::kStage + co_l * T::kCoS;
      const float* xs = smem + cur * T::kStage + T::kDy + cg * 4;
#pragma unroll 1
      for (int r = 0; r < R; ++r) {
        const float* d = dys + 2 * r * T::kCols;
        const float* xr = xs + r * W * kXP;
        float win[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 v = *reinterpret_cast<const float2*>(d + i * T::kCols);
          win[i][0] = v.x;
          win[i][1] = v.y;
        }
#pragma unroll
        for (int iw = 0; iw < W; ++iw) {
          const float4 a = *reinterpret_cast<const float4*>(xr + iw * kXP);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 v = *reinterpret_cast<const float2*>(
                d + i * T::kCols + 2 * iw + 2);
            win[i][2] = v.x;
            win[i][3] = v.y;
          }
          const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[k][i][j] = fmaf(av[k], win[i][j], acc[k][i][j]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            win[i][0] = win[i][2];
            win[i][1] = win[i][3];
          }
        }
      }
    }
    __syncthreads();
  }

  const int co = co0 + co_l;
  if (t >= kCompute || co >= Co) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ci = ci0 + cg * 4 + k;
    if (ci >= Ci) break;
    float4* out = reinterpret_cast<float4*>(
        ws + (((long long)split * Ci + ci) * Co + co) * 16);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out[i] = make_float4(acc[k][i][0], acc[k][i][1], acc[k][i][2],
                           acc[k][i][3]);
  }
}

// dw = the sum of the workspace's S splits, in split order.
__global__ void deconv_wgrad_sum_kernel(const float4* __restrict__ ws,
                                        float4* __restrict__ dw,
                                        long long n4, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n4; i += (long long)gridDim.x * blockDim.x) {
    float4 s = ws[i];
    for (int k = 1; k < splits; ++k) {
      const float4 v = ws[k * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    dw[i] = s;
  }
}

template <typename F>
int dispatch(int W, F&& f) {
  switch (W) {
    case 4: return f(Tile<4, 4>(), deconv_wgrad_kernel<4, 4>);
    case 8: return f(Tile<8, 8>(), deconv_wgrad_kernel<8, 8>);
    case 16: return f(Tile<16, 4>(), deconv_wgrad_kernel<16, 4>);
    case 32: return f(Tile<32, 2>(), deconv_wgrad_kernel<32, 2>);
    default: return -1;
  }
}

int ceil_div(long long a, int b) { return (int)((a + b - 1) / b); }

}  // namespace

// The number of K splits for these shapes on the current device: the
// fewest whole waves of resident blocks that the tiles fill to 97% or
// more (at most 8 waves), no more splits than chunks. -1 for a width the
// kernel is not built for, or a CUDA error.
extern "C" int deconv_wgrad_splits(int B, int Ci, int Co, int H, int W) {
  return dispatch(W, [&](auto tile, auto kernel) {
    using T = decltype(tile);
    constexpr int R = (T::kRows - 2) / 2;
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kBytes) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, kThreads, T::kBytes) != cudaSuccess ||
        per_sm < 1)
      return -1;
    const long long tiles = (long long)ceil_div(Ci, kCiT) * ceil_div(Co, kCoT);
    const long long chunks = (long long)B * ceil_div(H, R);
    const long long slots = (long long)sms * per_sm;
    long long best = 1;
    for (int waves = 1; waves <= 8; ++waves) {
      const long long s = waves * slots / tiles;
      if (s < 1) continue;
      best = s;
      if (s * tiles * 100 >= 97LL * waves * slots) break;
    }
    return (int)(best < chunks ? best : (chunks > 0 ? chunks : 1));
  });
}

// dw (C_in, C_out, 4, 4) of x (B, C_in, H, W) and dy (B, C_out, 2H, 2W),
// through the workspace ws (splits, C_in, C_out, 16). Returns a CUDA error,
// 1 for bad arguments.
extern "C" int deconv_wgrad(const void* x, const void* dy, void* ws,
                            void* dw, int B, int Ci, int Co, int H, int W,
                            int splits, void* stream) {
  if (B < 1 || Ci < 1 || Co < 1 || H < 1 || splits < 1 ||
      (long long)B * Co * 4 * H * W >= (1LL << 31) ||
      (long long)B * Ci * H * W >= (1LL << 31) ||
      (long long)splits * Ci * Co * 16 >= (1LL << 31))
    return 1;
  const cudaStream_t st = (cudaStream_t)stream;
  const int rc = dispatch(W, [&](auto tile, auto kernel) {
    using T = decltype(tile);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kBytes);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(ceil_div(Co, kCoT), ceil_div(Ci, kCiT), splits);
    kernel<<<grid, kThreads, T::kBytes, st>>>(
        (const float*)x, (const float*)dy, (float*)ws, B, Ci, Co, H, splits);
    return (int)cudaGetLastError();
  });
  if (rc != 0) return rc < 0 ? 1 : rc;
  const long long n4 = (long long)Ci * Co * 4;
  const int blocks = ceil_div(n4, 256) < 1024 ? ceil_div(n4, 256) : 1024;
  deconv_wgrad_sum_kernel<<<blocks, 256, 0, st>>>(
      (const float4*)ws, (float4*)dw, n4, splits);
  return (int)cudaGetLastError();
}
