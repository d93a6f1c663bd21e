// Anti-aliased SnakeBeta, y = down2(s(up2(x))), on (B, T, C) float32.
//
// Replaces megatts2_hierspeechpp_tpu/ops/pallas_snake.py (_kernel,
// _kernel_tr). Bound by bytes on the H100 (read x, write y). One block per
// (time tile, 32-channel chunk, batch row): x tile + 6-sample halo and the
// x2 intermediate s(u) live in shared memory only. See taps.cuh for the edge
// rule.
#include <cuda_runtime.h>

#include "taps.cuh"

namespace {

constexpr int kTile = 64;      // output samples per block
constexpr int kThreads = 256;  // 8 warps; lane = channel, warp = row

__global__ void __launch_bounds__(kThreads)
aa_snakebeta_kernel(const float* __restrict__ x,
                    const float* __restrict__ alpha,
                    const float* __restrict__ inv_beta,
                    float* __restrict__ y, int T, int C) {
  __shared__ float xs[(kTile + 12) * kChunk];
  __shared__ float us[(2 * kTile + 10) * kChunk];
  const int t0 = blockIdx.x * kTile;
  const int c = blockIdx.y * kChunk + (threadIdx.x & 31);
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, n_warps = kThreads / 32;
  const bool cok = c < C;
  const float* xb = x + (size_t)b * T * C;

  stage_x(xs, xb, t0, kTile, T, C, c, cok, warp, n_warps);
  __syncthreads();
  stage_u(us, xs, t0, kTile, T, cok ? alpha[c] : 0.f,
          cok ? inv_beta[c] : 0.f, warp, n_warps);
  __syncthreads();
  float* yb = y + (size_t)b * T * C;
  for (int r = warp; r < kTile; r += n_warps) {
    const int t = t0 + r;
    if (t < T && cok) yb[(size_t)t * C + c] = down_at(us, r);
  }
}

}  // namespace

extern "C" int aa_snakebeta_fwd(const float* x, const float* alpha,
                                const float* inv_beta, float* y, int B, int T,
                                int C, void* stream) {
  dim3 grid((T + kTile - 1) / kTile, (C + kChunk - 1) / kChunk, B);
  aa_snakebeta_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, alpha, inv_beta, y, T, C);
  return (int)cudaGetLastError();
}
