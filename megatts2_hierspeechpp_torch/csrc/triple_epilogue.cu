// Epilogue of an AMPBlock triple (one decoder stage): the average of the
// three block outputs and, for the last stage, the network tail
//
//   y = tanh(conv_post(snake(avg)))   conv_post: C -> 1, k = 7, no bias
//
// written straight to the (B, T, 1) waveform.
//
// Replaces the averaging and tail of megatts2_hierspeechpp_tpu/ops/
// pallas_amp_triple.py:_kernel (its blocks run through snake_conv.cu).
// Bound by bytes on the H100: it reads the three (B, T, C) block outputs
// once and writes (B, T, C), or only (B, T, 1) with the tail. The tail
// kernel never writes the average: one block per (64-sample tile, batch
// row) stages the average plus a 9-sample halo in shared memory, runs the
// anti-aliased snake there (taps.cuh), and reduces the 7 x C taps per
// output over 4 thread groups.
#include <cuda_runtime.h>

#include <algorithm>

#include "taps.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kW = kTile + 6;  // conv_post input window, 3 each side
constexpr int kSW = kW | 1;

__global__ void triple_avg_kernel(const float* __restrict__ r0,
                                  const float* __restrict__ r1,
                                  const float* __restrict__ r2,
                                  float* __restrict__ y, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    y[i] = (r0[i] + r1[i] + r2[i]) / 3.0f;
}

__global__ void __launch_bounds__(kThreads)
triple_post_kernel(const float* __restrict__ r0, const float* __restrict__ r1,
                   const float* __restrict__ r2,
                   const float* __restrict__ alpha,
                   const float* __restrict__ inv_beta,
                   const float* __restrict__ w7,  // (7, C)
                   float* __restrict__ y, int T, int C) {
  __shared__ float xs[(kW + 12) * kChunk];
  __shared__ float us[(2 * kW + 10) * kChunk];
  __shared__ float ss[kChunk * kSW];
  __shared__ float part[4][kTile];
  const int t0 = blockIdx.x * kTile;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = kThreads / 32;
  const int w0 = t0 - 3;
  const size_t off = (size_t)b * T * C;
  const int group = threadIdx.x / kTile, tt = threadIdx.x % kTile;

  float acc = 0.f;
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int c = c0 + lane;
    const bool cok = c < C;
    for (int r = warp; r < kW + 12; r += n_warps) {
      const size_t i = off + (size_t)clampi(w0 - 6 + r, 0, T - 1) * C + c;
      xs[r * kChunk + lane] = cok ? (r0[i] + r1[i] + r2[i]) / 3.0f : 0.f;
    }
    __syncthreads();
    stage_u(us, xs, w0, kW, T, cok ? alpha[c] : 0.f, cok ? inv_beta[c] : 0.f,
            warp, n_warps);
    __syncthreads();
    for (int r = warp; r < kW; r += n_warps) {
      const int p = w0 + r;
      ss[lane * kSW + r] = (p >= 0 && p < T) ? down_at(us, r) : 0.f;
    }
    __syncthreads();
    const int n_ci = min(kChunk, C - c0);
    for (int ci = group; ci < n_ci; ci += 4) {
#pragma unroll
      for (int j = 0; j < 7; ++j)
        acc = fmaf(w7[j * C + c0 + ci], ss[ci * kSW + tt + j], acc);
    }
    __syncthreads();
  }
  part[group][tt] = acc;
  __syncthreads();
  if (group == 0) {
    const int t = t0 + tt;
    if (t < T)
      y[(size_t)b * T + t] =
          tanhf(part[0][tt] + part[1][tt] + part[2][tt] + part[3][tt]);
  }
}

}  // namespace

extern "C" int triple_avg_fwd(const float* r0, const float* r1,
                              const float* r2, float* y, int n,
                              void* stream) {
  const int blocks = std::max(1, std::min((n + kThreads - 1) / kThreads, 132 * 16));
  triple_avg_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(r0, r1, r2,
                                                                    y, n);
  return (int)cudaGetLastError();
}

extern "C" int triple_post_fwd(const float* r0, const float* r1,
                               const float* r2, const float* alpha,
                               const float* inv_beta, const float* w7,
                               float* y, int B, int T, int C, void* stream) {
  dim3 grid((T + kTile - 1) / kTile, B);
  triple_post_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      r0, r1, r2, alpha, inv_beta, w7, y, T, C);
  return (int)cudaGetLastError();
}
