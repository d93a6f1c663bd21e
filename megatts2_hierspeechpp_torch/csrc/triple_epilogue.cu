// Epilogue of an AMPBlock triple (one decoder stage): the average of the
// three block outputs and, for the last stage, the network tail
//
//   y = tanh(conv_post(snake(avg)))   conv_post: C -> 1, k = 7, no bias
//
// written straight to the (B, T, 1) waveform. The block outputs are
// float32. The average is written as float32, or as bf16 in the TPU
// kernels' bf16 configuration (rounded once on store); the tail here is
// float32's, and the bf16 configuration's tail is triple_post_bf16.cu,
// planned for its own error budget.
//
// Replaces the averaging and tail of megatts2_hierspeechpp_tpu/ops/
// pallas_amp_triple.py:_kernel (its blocks run through snake_conv.cu).
// Bound by bytes on the H100: it reads the three (B, T, C) block outputs
// once and writes (B, T, C), or only (B, T, 1) with the tail; the tail's
// arithmetic (about 75 flops per element) comes close behind.
//
// The tail kernel never writes the average. One block per (tile of L
// outputs, batch row), three phases split by two barriers, several blocks
// per SM so that one block's loads overlap another's arithmetic:
//   1. the average of rows t0 - 8 .. t0 + L + 9 (clamped) into shared
//      memory, 16-byte loads of the three inputs, 12 in flight per thread;
//   2. AA-snake of rows t0 - 3 .. t0 + L + 4, a thread per (channel, 16
//      rows) with the x window and the down-filter sums in registers
//      (taps.cuh aa_window), stored channel-major with an odd row stride so
//      that phase 3 reads without bank conflicts (0 outside [0, T): the
//      conv's zero padding);
//   3. a thread per output: the 7 x C taps from shared memory (a
//      channel's 7 weights in two 16-byte broadcast reads) in a fixed
//      order (no atomics), tanh, one store.
// L is one of kTiles (rows L + 8 in phase 2, 2 x 16 + 10 s(u) per 16 rows);
// the plan (ops/amp_triple.py:epilogue_plan) takes the first whose shared
// memory, 4 C (2 (L + 8) + 19) bytes, fits. The entry point refuses a tile
// it does not know or shared bytes that do not match it. A persistent
// variant that brought the next tile in by cp.async during this one's
// arithmetic measured slower: its extra buffer and registers cost more
// blocks per SM than the overlap won (PERF.md).
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <iterator>

#include "taps.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kR = 16;  // AA-snake rows per thread task (phase 2)
constexpr int kSmemLimit = 232448;
constexpr int kTiles[] = {248, 120, 56, 24};
constexpr int kMaxDevices = 64;  // cards whose shared memory opt-in is kept

// conv_post weights C x 8 (7 taps and a pad, two 16-byte reads per
// channel), average (rows + 10) x C, AA-snake C x (rows + 1)
int post_smem(int C, int rows) { return 4 * C * (2 * rows + 19); }

template <typename Out>
__global__ void triple_avg_kernel(const float* __restrict__ r0,
                                  const float* __restrict__ r1,
                                  const float* __restrict__ r2,
                                  Out* __restrict__ y, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    st_act(y + i, (r0[i] + r1[i] + r2[i]) / 3.0f);
}

__device__ __forceinline__ float4 avg3(float4 a, float4 b, float4 c) {
  return make_float4((a.x + b.x + c.x) / 3.0f, (a.y + b.y + c.y) / 3.0f,
                     (a.z + b.z + c.z) / 3.0f, (a.w + b.w + c.w) / 3.0f);
}

template <typename Out>
__global__ void __launch_bounds__(kThreads)
triple_post_kernel(const float* __restrict__ r0, const float* __restrict__ r1,
                   const float* __restrict__ r2,
                   const float* __restrict__ alpha,
                   const float* __restrict__ inv_beta,
                   const float* __restrict__ w7,  // (7, C)
                   Out* __restrict__ y, int T, int C, int tile,
                   bool vec4, long long* __restrict__ stamps) {
  extern __shared__ float4 smem4[];
  const int rows = tile + 8, nx = rows + 10, stride = rows + 1;
  const float4* ws = smem4;  // C x 8: conv_post taps of channel c
  float* xs = reinterpret_cast<float*>(smem4 + 2 * C);  // nx x C: avg at t0 - 8 + i
  float* as = xs + nx * C;   // C x stride: AA-snake at t0 - 3 + i
  const int t0 = blockIdx.x * tile;
  const size_t off = (size_t)blockIdx.y * T * C;
  // stamps (diagnostic, null on the path): SM cycles at the start and
  // after each phase, per block
  long long* st = stamps ? stamps + 4 * (blockIdx.y * gridDim.x + blockIdx.x) : nullptr;
  if (st && threadIdx.x == 0) st[0] = clock64();

  // 1. the average, clamped rows
  for (int i = threadIdx.x; i < 8 * C; i += kThreads)
    reinterpret_cast<float*>(smem4)[i] = i % 8 < 7 ? w7[(i % 8) * C + i / 8] : 0.f;
  if (vec4) {  // C % 4 == 0 and 16-byte aligned inputs
    const int n4 = nx * C / 4;
    for (int i0 = threadIdx.x; i0 < n4; i0 += 4 * kThreads) {
      float4 v0[4], v1[4], v2[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreads;
        if (i < n4) {
          const int e = 4 * i, row = e / C;
          const size_t gi =
              off + (size_t)clampi(t0 - 8 + row, 0, T - 1) * C + (e - row * C);
          v0[u] = __ldg(reinterpret_cast<const float4*>(r0 + gi));
          v1[u] = __ldg(reinterpret_cast<const float4*>(r1 + gi));
          v2[u] = __ldg(reinterpret_cast<const float4*>(r2 + gi));
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreads;
        if (i < n4) reinterpret_cast<float4*>(xs)[i] = avg3(v0[u], v1[u], v2[u]);
      }
    }
  } else {
    for (int e = threadIdx.x; e < nx * C; e += kThreads) {
      const int row = e / C;
      const size_t gi =
          off + (size_t)clampi(t0 - 8 + row, 0, T - 1) * C + (e - row * C);
      xs[e] = (__ldg(r0 + gi) + __ldg(r1 + gi) + __ldg(r2 + gi)) / 3.0f;
    }
  }
  __syncthreads();
  if (st && threadIdx.x == 0) st[1] = clock64();

  // 2. AA-snake, a thread per (channel, kR rows)
  for (int task = threadIdx.x; task < (rows / kR) * C; task += kThreads) {
    const int c = task % C, seg = task / C;
    const int p0 = t0 - 3 + seg * kR;
    const float al = __ldg(alpha + c), ib = __ldg(inv_beta + c);
    float* a = as + c * stride + seg * kR;
    float xw[kR + 10];  // x[clamp(p0 - 5 + i)] is row seg * kR + i
#pragma unroll
    for (int i = 0; i < kR + 10; ++i) xw[i] = xs[(seg * kR + i) * C + c];
    // the clamped s(u) at the sequence edges, where this task reaches one
    const auto x_at = [&](int q) { return xs[(q - (t0 - 8)) * C + c]; };
    const float s_lo = p0 < 3 ? su_at(x_at, 0, T, al, ib) : 0.f;
    const float s_hi =
        p0 + kR > T - 3 ? su_at(x_at, 2 * T - 1, T, al, ib) : 0.f;
    float out[kR];
    aa_window<kR>(xw, p0, T, s_lo, s_hi, al, ib, out);
#pragma unroll
    for (int r = 0; r < kR; ++r)
      a[r] = (p0 + r >= 0 && p0 + r < T) ? out[r] : 0.f;
  }
  __syncthreads();
  if (st && threadIdx.x == 0) st[2] = clock64();

  // 3. conv_post + tanh, a thread per output
  for (int o = threadIdx.x; o < tile; o += kThreads) {
    const int t = t0 + o;
    if (t >= T) break;
    float acc0 = 0.f, acc1 = 0.f;  // two chains: even and odd channels
    for (int c = 0; c < C; ++c) {
      const float4 w0 = ws[2 * c], w1 = ws[2 * c + 1];  // broadcast reads
      const float w[7] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z};
      const float* a = as + c * stride + o;  // rows t - 3 .. t + 3
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < 7; ++j) v = fmaf(w[j], a[j], v);
      if (c & 1) acc1 += v; else acc0 += v;
    }
    st_act(y + (size_t)blockIdx.y * T + t, tanhf(acc0 + acc1));
  }
  if (st) {
    __syncthreads();
    if (threadIdx.x == 0) st[3] = clock64();
  }
}

template <typename Out>
int launch_avg(const float* r0, const float* r1, const float* r2, void* y,
               int n, cudaStream_t stream) {
  const int blocks = std::max(1, std::min((n + kThreads - 1) / kThreads, 132 * 16));
  triple_avg_kernel<Out><<<blocks, kThreads, 0, stream>>>(
      r0, r1, r2, static_cast<Out*>(y), n);
  return (int)cudaGetLastError();
}

template <typename Out>
int launch_post(const float* r0, const float* r1, const float* r2,
                const float* alpha, const float* inv_beta, const float* w7,
                void* y, int B, int T, int C, int tile, int smem_bytes,
                long long* stamps, cudaStream_t stream) {
  // the shared memory limit is raised per device; the largest set so far
  static int opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem_bytes > 48 * 1024 && smem_bytes > opted_in[dev]) {
    err = cudaFuncSetAttribute(triple_post_kernel<Out>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = smem_bytes;
  }
  const bool vec4 = C % 4 == 0 &&
      (((uintptr_t)r0 | (uintptr_t)r1 | (uintptr_t)r2) & 15) == 0;
  dim3 grid((T + tile - 1) / tile, B);
  triple_post_kernel<Out><<<grid, kThreads, smem_bytes, stream>>>(
      r0, r1, r2, alpha, inv_beta, w7, static_cast<Out*>(y), T, C, tile, vec4,
      stamps);
  return (int)cudaGetLastError();
}

}  // namespace

// y_bytes: 4 for a float32 output, 2 for bf16.
extern "C" int triple_avg_fwd(const float* r0, const float* r1,
                              const float* r2, void* y, int n, int y_bytes,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (y_bytes == 4) return launch_avg<float>(r0, r1, r2, y, n, s);
  if (y_bytes == 2) return launch_avg<bf16>(r0, r1, r2, y, n, s);
  return (int)cudaErrorInvalidValue;
}

// tile and smem_bytes: the caller's plan (ops/amp_triple.py:epilogue_plan),
// one of kTiles with the shared memory that tile needs, within the limit.
// stamps: null, or 4 int64 per block (B x ceil(T / tile)). y: the float32
// waveform.
extern "C" int triple_post_fwd(const float* r0, const float* r1,
                               const float* r2, const float* alpha,
                               const float* inv_beta, const float* w7,
                               void* y, int B, int T, int C, int tile,
                               int smem_bytes, long long* stamps,
                               void* stream) {
  const bool known = std::find(std::begin(kTiles), std::end(kTiles), tile) !=
                     std::end(kTiles);
  if (B < 1 || T < 1 || C < 1 || !known ||
      smem_bytes != post_smem(C, tile + 8) || smem_bytes > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  return launch_post<float>(r0, r1, r2, alpha, inv_beta, w7, y, B, T, C, tile,
                            smem_bytes, stamps, (cudaStream_t)stream);
}
