// Anti-aliased SnakeBeta -> dilated 1-D convolution (+ bias, + optional
// residual), on (B, T, C) float32. One AMPBlock branch is two launches:
//
//   c1 = conv_d(snake1(x)) + b1
//   x' = conv_1(snake2(c1)) + b2 + x
//
// so a whole AMPBlock is 6 launches (ops/ampblock.py) and an AMPBlock
// triple 18 plus its epilogue (ops/amp_triple.py).
//
// Replaces the per-layer work of megatts2_hierspeechpp_tpu/ops/
// pallas_ampblock.py:_kernel and pallas_amp_triple.py:_kernel. Those keep a
// whole block (or stage) in 16 MB of VMEM; its weights alone (4.3 MB at
// C=128, k=11) do not fit a Hopper block's 227 KB of shared memory, so this
// design fuses one snake and one conv per launch and sends the conv
// outputs through device memory.
//
// Bound on the H100: float32 operations (2*K*Cin flops per output), at the
// card's non-tensor f32 rate; TF32 is off by contract. A block computes a
// (32 output channels x 64 samples) tile. Per 32-channel input chunk it
// stages snake(x) over the receptive window [t0 - hd, t0 + 64 + hd) in
// shared memory (zero outside [0, T): the conv's zero padding; the snake
// itself uses the clamped edges of taps.cuh), then accumulates the K taps
// with each thread holding 4 channels x 2 samples in registers. Weights are
// read through the read-only cache; all lanes of a warp read the same one.
#include <cuda_runtime.h>

#include "taps.cuh"

namespace {

constexpr int kTile = 64;      // output samples per block
constexpr int kCoTile = 32;    // output channels per block
constexpr int kThreads = 256;  // 8 warps x 4 output channels each

__global__ void __launch_bounds__(kThreads)
snake_conv_kernel(const float* __restrict__ x, const float* __restrict__ alpha,
                  const float* __restrict__ inv_beta,
                  const float* __restrict__ w,  // (K, Cout, Cin)
                  const float* __restrict__ bias,
                  const float* __restrict__ res,  // (B, T, Cout) or null
                  float* __restrict__ y, int T, int Cin, int Cout, int K,
                  int dil) {
  extern __shared__ float smem[];
  const int hd = (K - 1) / 2 * dil;
  const int W = kTile + (K - 1) * dil;  // conv input window
  const int SW = W | 1;                 // odd row stride: no bank conflicts
  float* xs = smem;                     // (W + 12) x kChunk
  float* us = xs + (W + 12) * kChunk;   // (2W + 10) x kChunk
  float* ss = us + (2 * W + 10) * kChunk;  // kChunk x SW, channel-major

  const int t0 = blockIdx.x * kTile;
  const int co0 = blockIdx.y * kCoTile;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = kThreads / 32;
  const int w0 = t0 - hd;
  const float* xb = x + (size_t)b * T * Cin;

  float acc[4][2] = {};
  for (int c0 = 0; c0 < Cin; c0 += kChunk) {
    const int c = c0 + lane;
    const bool cok = c < Cin;
    stage_x(xs, xb, w0, W, T, Cin, c, cok, warp, n_warps);
    __syncthreads();
    stage_u(us, xs, w0, W, T, cok ? alpha[c] : 0.f, cok ? inv_beta[c] : 0.f,
            warp, n_warps);
    __syncthreads();
    for (int r = warp; r < W; r += n_warps) {
      const int p = w0 + r;
      ss[lane * SW + r] = (p >= 0 && p < T) ? down_at(us, r) : 0.f;
    }
    __syncthreads();
    const int n_ci = min(kChunk, Cin - c0);
    for (int ci = 0; ci < n_ci; ++ci) {
      const float* srow = ss + ci * SW + lane;
      for (int j = 0; j < K; ++j) {
        const float s0 = srow[j * dil], s1 = srow[j * dil + 32];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int co = co0 + warp * 4 + n;
          const float wv =
              co < Cout ? __ldg(w + ((size_t)j * Cout + co) * Cin + c0 + ci)
                        : 0.f;
          acc[n][0] = fmaf(wv, s0, acc[n][0]);
          acc[n][1] = fmaf(wv, s1, acc[n][1]);
        }
      }
    }
    __syncthreads();
  }

  const size_t row0 = (size_t)b * T;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int co = co0 + warp * 4 + n;
    if (co >= Cout) continue;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int t = t0 + lane + 32 * m;
      if (t >= T) continue;
      const size_t o = (row0 + t) * Cout + co;
      float v = acc[n][m] + bias[co];
      if (res != nullptr) v += res[o];
      y[o] = v;
    }
  }
}

}  // namespace

extern "C" int snake_conv_fwd(const float* x, const float* alpha,
                              const float* inv_beta, const float* w,
                              const float* bias, const float* res, float* y,
                              int B, int T, int Cin, int Cout, int K, int dil,
                              void* stream) {
  const int W = kTile + (K - 1) * dil;
  const size_t smem =
      sizeof(float) * ((size_t)(W + 12) * kChunk + (size_t)(2 * W + 10) * kChunk +
                       (size_t)kChunk * (W | 1));
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        snake_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  dim3 grid((T + kTile - 1) / kTile, (Cout + kCoTile - 1) / kCoTile, B);
  snake_conv_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, alpha, inv_beta, w, bias, res, y, T, Cin, Cout, K, dil);
  return (int)cudaGetLastError();
}
