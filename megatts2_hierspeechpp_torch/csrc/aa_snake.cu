// Anti-aliased SnakeBeta, y = down2(s(up2(x))), on (B, T, C) float32
// (the bf16 configuration is aa_snake_bf16.cu).
//
// Replaces megatts2_hierspeechpp_tpu/ops/pallas_snake.py (_kernel,
// _kernel_tr). Bound by bytes on the H100 (read x, write y), but on the
// serving path x (2 MB) has just been written and sits in L2, so what is
// left is the arithmetic of the s(u) and the ramp of one short launch. The design therefore has no shared memory and no block
// barrier: a thread owns one channel (neighbouring threads on neighbouring
// channels, so each row a warp loads is 128 contiguous bytes) and R
// consecutive outputs; the 4 warps of a block take 4 consecutive segments,
// so the halo rows they share are L1 hits. It loads the R + 10 x rows those outputs read,
// computes each of the 2R + 10 s(u) once and feeds the 12-tap down filter
// from registers (taps.cuh aa_window). At a sequence edge the clamped s(u)
// of the first and last u index are computed once more and stand in where
// the index clamps, so the edges are exact (see taps.cuh for the edge
// rule).
//
// The launch plan (R and the grid) is ops/snake.py:snake_plan; the entry
// point recomputes the grid and refuses a plan that disagrees.
#include <cuda_runtime.h>

#include "taps.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps: 4 time segments of 32 channels

// Block: 32 channels (one per lane) x 4 consecutive segments of R outputs
// (one per warp), so the 10 halo rows two segments share come from L1.
// Blocks run channel chunk fastest, then segment group, then batch row.
template <int R>
__global__ void __launch_bounds__(kThreads)
aa_snakebeta_kernel(const float* __restrict__ x,
                    const float* __restrict__ alpha,
                    const float* __restrict__ inv_beta,
                    float* __restrict__ y, int B, int T, int C) {
  const int chunks = (C + 31) / 32, segs = (T + R - 1) / R;
  const int groups = (segs + 3) / 4;
  const int c = (blockIdx.x % chunks) * 32 + (threadIdx.x & 31);
  const int rest = blockIdx.x / chunks;
  const int seg = (rest % groups) * 4 + (threadIdx.x >> 5);
  const int b = rest / groups;
  if (c >= C || seg >= segs || b >= B) return;
  const int t0 = seg * R;
  const float* xb = x + (size_t)b * T * C + c;
  float* yb = y + (size_t)b * T * C + c;
  const float al = __ldg(alpha + c), ib = __ldg(inv_beta + c);

  float xw[R + 10];
#pragma unroll
  for (int i = 0; i < R + 10; ++i)  // rows t0 - 5 .. t0 + R + 4, clamped
    xw[i] = ld_act(xb + (size_t)clampi(t0 - 5 + i, 0, T - 1) * C);
  // the clamped s(u) at the sequence edges, where this thread reaches one
  const auto x_at = [&](int q) { return ld_act(xb + (size_t)q * C); };
  const float s_lo = t0 < 3 ? su_at(x_at, 0, T, al, ib) : 0.f;
  const float s_hi = t0 + R > T - 3 ? su_at(x_at, 2 * T - 1, T, al, ib) : 0.f;
  float out[R];
  aa_window<R>(xw, t0, T, s_lo, s_hi, al, ib, out);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (t0 + r >= T) break;
    st_act(yb + (size_t)(t0 + r) * C, out[r]);
  }
}

template <int R>
int launch(const void* x, const float* alpha, const float* inv_beta, void* y,
           int B, int T, int C, int blocks, cudaStream_t stream) {
  aa_snakebeta_kernel<R><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(x), alpha, inv_beta, static_cast<float*>(y), B,
      T, C);
  return (int)cudaGetLastError();
}

}  // namespace

// rows (R) in {4, 8}; blocks must be the grid of that plan,
// B * ceil(ceil(T / R) / 4) * ceil(C / 32).
extern "C" int aa_snakebeta_fwd(const void* x, const float* alpha,
                                const float* inv_beta, void* y, int B, int T,
                                int C, int rows, int blocks, void* stream) {
  if (B < 1 || T < 1 || C < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  const long long want = (long long)B * (((T + rows - 1) / rows + 3) / 4) *
                         ((C + 31) / 32);
  if (blocks != want) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (rows) {
    case 4: return launch<4>(x, alpha, inv_beta, y, B, T, C, blocks, s);
    case 8: return launch<8>(x, alpha, inv_beta, y, B, T, C, blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}
