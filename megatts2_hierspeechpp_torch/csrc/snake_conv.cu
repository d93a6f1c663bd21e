// Anti-aliased SnakeBeta -> dilated 1-D convolution (+ bias, + optional
// residual), on (B, T, C) float32, with the conv on the tensor cores in
// split TF32. One AMPBlock branch is two launches:
//
//   c1 = conv_d(snake1(x)) + b1
//   x' = conv_1(snake2(c1)) + b2 + x
//
// so a whole AMPBlock is 6 launches (ops/ampblock.py) and an AMPBlock
// triple 18 plus its epilogue (ops/amp_triple.py).
//
// Replaces the per-layer work of megatts2_hierspeechpp_tpu/ops/
// pallas_ampblock.py:_kernel and pallas_amp_triple.py:_kernel. Those keep a
// whole block (or stage) in 16 MB of VMEM and run every conv tap on the MXU
// at Precision.HIGHEST (float32 from several bf16 passes). A Hopper block
// has 227 KB of shared memory, less than one block's weights (4.3 MB at
// C=128, k=11), so this kernel fuses one snake and one conv per launch and
// the conv outputs go through device memory.
//
// Arithmetic. Per tap j the conv is a product (time x Cin) @ (Cin x Cout),
// summed over taps. Each operand is split into a = hi + lo with hi =
// tf32(a), lo = tf32(a - hi) (cvt.rna.tf32.f32): the snake window once, as
// it is written to shared memory; the weights as their fragments are loaded
// (that costs a few conversions, and saves a split pass and a barrier per
// tap). Every product is the three tensor-core products
// lo*hi + hi*lo + hi*hi (mma.sync m16n8k8 tf32). Each 8-channel step's three
// products start from zero and join the running sum with a float32 add
// (round to nearest), since the tensor cores truncate when they accumulate.
// This is as accurate as float32; a single TF32 pass is not, and there is
// no such path. Error of a 6-conv AMPBlock-like chain against float64,
// relative to max|ref|, with tf32 rounding emulated on the CPU (T = 4096):
//
//   arithmetic   C=128 k=11   C=32 k=11   C=16 k=3
//   float32      7.0e-7       6.3e-7      3.8e-7
//   1xTF32       8.6e-4       7.7e-4      8.8e-4
//   3xTF32       6.6e-7       6.5e-7      4.1e-7
//
// tests/test_torch_tf32split.py repeats that emulation on the plain path.
//
// Bound on the H100: the 3xTF32 products (3 x 2 K Cin flops per output at
// 495 TFLOP/s) for most shapes, the snake's float32 work (about 60 flops
// and 2 sinf per element, on the 67 TFLOP/s float32 pipes) at small C and
// k, and device memory for the conv outputs between launches (61 MB per
// tensor at SpeechSR, beyond the 50 MB L2).
//
// Design. A block covers TM time samples (128, 64 or 32, chosen by T so
// that short shapes still fill the card) and TN output channels, all of
// Cout where T allows it, so the snake of the input window runs once per
// (time tile, input channel): over the conv halo (K-1)d and the
// resampler's +-6 samples, never once per output-channel tile. Per 32-
// channel input chunk:
//   - x over [t0 - hd - 6, t0 - hd + W + 6) arrives by cp.async (clamped
//     rows: the replicate pads of taps.cuh, exact at every T >= 1);
//   - each warp streams the snake down a run of window rows, one channel
//     per lane, the 12 down-filter inputs in registers, and writes the hi
//     and lo parts of s(x) (zero outside [0, T): the conv's zero padding);
//   - per tap, the (TN x 32) weight slice arrives by cp.async two taps
//     ahead, into a ring of three slices: one block barrier per tap;
//   - warps tile (TM x TN) as WM x WN, each MT x NT mma tiles; fragments
//     of tap j read the window shifted by j d rows.
// Rows of 36 floats (32 + 4) make every fragment load free of bank
// conflicts, whatever the shift. Cout from 1 to 128, any Cin: padding
// channels are zero-filled.
//
// The bf16 configuration (bf16 conv operands, float32 sums) is
// snake_conv_bf16.cu's: wgmma on packed bf16 weights.
//
// Resources (ptxas -v, sm_90a; build/kernels/build.log): 120-127 registers
// for every tile but 128 x 128 (168), no spills, no static shared memory.
// Dynamic shared memory is (W + 12) 32 + 2 W 36 + 3 TN 36 floats, W = TM +
// (K-1)d: at k=11, d=5, 89 KB for SpeechSR's 128 x 32 tiles (two blocks per
// SM) and 104 KB for Generator stage 1's 64 x 128.
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "taps.cuh"

namespace {

constexpr int kS = kChunk + 4;  // shared row stride of window and weights

__device__ __forceinline__ uint32_t tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

__device__ __forceinline__ void split(float v, uint32_t* hi, uint32_t* lo) {
  const uint32_t h = tf32(v);
  *hi = h;
  *lo = tf32(v - __uint_as_float(h));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// cp.async of 4 or 16 bytes; ok == false zero-fills and reads nothing.
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Wait for all but the newest group.
__device__ __forceinline__ void cp_wait_prev() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

constexpr int kStages = 3;  // weight slices in flight: this tap, next two

// Shared bytes of one block: x rows, the window (hi + lo parts), the weight
// ring.
inline size_t smem_bytes(int tm, int tn, int K, int dil) {
  const size_t W = tm + (size_t)(K - 1) * dil;
  return sizeof(float) *
         ((W + 12) * kChunk + 2 * W * kS + (size_t)kStages * tn * kS);
}

template <int WM, int WN, int MT, int NT>
__global__ void __launch_bounds__(WM * WN * 32)
snake_conv_kernel(const float* __restrict__ x, const float* __restrict__ alpha,
                  const float* __restrict__ inv_beta,
                  const float* __restrict__ w,  // (K, Cout, Cin)
                  const float* __restrict__ bias,
                  const float* __restrict__ res,  // (B, T, Cout) or null
                  float* __restrict__ y, int T, int Cin, int Cout, int K,
                  int dil, int vec) {
  constexpr int kThreads = WM * WN * 32, kWarps = WM * WN;
  constexpr int TM = WM * MT * 16, TN = WN * NT * 8;
  extern __shared__ __align__(16) float smem[];
  const int hd = (K - 1) / 2 * dil;
  const int W = TM + (K - 1) * dil;  // conv input window
  float* xs = smem;                  // (W + 12) x kChunk
  // the window: hi and lo parts, W x kS each
  uint32_t* ahi = reinterpret_cast<uint32_t*>(xs + (W + 12) * kChunk);
  uint32_t* alo = ahi + W * kS;
  float* wring = reinterpret_cast<float*>(ahi + 2 * W * kS);  // kStages x TN x kS

  const int t0 = blockIdx.x * TM, n0 = blockIdx.y * TN, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const int w0 = t0 - hd;
  const float* xb = x + (size_t)b * T * Cin;

  auto stage_x = [&](int c0) {
    if (vec) {
      for (int i = tid; i < (W + 12) * 8; i += kThreads) {
        const int r = i >> 3, q = (i & 7) * 4;
        const int p = clampi(w0 - 6 + r, 0, T - 1);
        const bool ok = c0 + q < Cin;
        cp16(xs + r * kChunk + q, ok ? xb + (size_t)p * Cin + c0 + q : xb, ok);
      }
    } else {
      for (int i = tid; i < (W + 12) * kChunk; i += kThreads) {
        const int r = i / kChunk, q = i % kChunk;
        const int p = clampi(w0 - 6 + r, 0, T - 1);
        const bool ok = c0 + q < Cin;
        cp4(xs + r * kChunk + q, ok ? xb + (size_t)p * Cin + c0 + q : xb, ok);
      }
    }
  };
  auto stage_w = [&](int step) {
    const int j = step % K, c0 = step / K * kChunk;
    float* wr = wring + (step % kStages) * TN * kS;
    if (vec) {
      for (int i = tid; i < TN * 8; i += kThreads) {
        const int co = i >> 3, q = (i & 7) * 4;
        const bool ok = n0 + co < Cout && c0 + q < Cin;
        cp16(wr + co * kS + q,
             ok ? w + ((size_t)j * Cout + n0 + co) * Cin + c0 + q : w, ok);
      }
    } else {
      for (int i = tid; i < TN * kChunk; i += kThreads) {
        const int co = i / kChunk, q = i % kChunk;
        const bool ok = n0 + co < Cout && c0 + q < Cin;
        cp4(wr + co * kS + q,
            ok ? w + ((size_t)j * Cout + n0 + co) * Cin + c0 + q : w, ok);
      }
    }
  };

  float acc[MT][NT][4] = {};
  const int n_chunks = (Cin + kChunk - 1) / kChunk;
  const int n_steps = n_chunks * K;
  // Commit groups: {x of chunk 0, w of step 0}, {w of step 1}, then one
  // per step (w of step + 2, with x of the next chunk at a chunk's first
  // step), so waiting for all but the newest group lands this step's w.
  stage_x(0);
  stage_w(0);
  cp_commit();
  if (n_steps > 1) stage_w(1);
  cp_commit();
  for (int step = 0; step < n_steps; ++step) {
    const int chunk = step / K, j = step % K, c0 = chunk * kChunk;
    if (j == 0)
      cp_wait_all();  // this chunk's x too
    else
      cp_wait_prev();
    __syncthreads();  // landed for every thread; the slot of step + 2 free
    if (j == 0) {
      // snake of the window, one channel per lane, rows split over warps
      const int c = c0 + lane;
      const float a = c < Cin ? alpha[c] : 0.f;
      const float ib = c < Cin ? inv_beta[c] : 0.f;
      const int rows = (W + kWarps - 1) / kWarps;
      const int ra = warp * rows, rb = min(W, ra + rows);
      if (ra < rb) {
        float ring[12];  // s(u[clamp(2 (w0 + r) + k - 5)]), k = 0..11
#pragma unroll
        for (int k = 0; k < 12; ++k)
          ring[k] = snake(up_at(xs, w0, T, 2 * (w0 + ra) + k - 5), a, ib);
        for (int r = ra;; ) {
          float v = 0.f;
#pragma unroll
          for (int k = 0; k < 12; ++k) v += kDown[k] * ring[k];
          const int p = w0 + r;
          v = p >= 0 && p < T ? v : 0.f;
          split(v, &ahi[r * kS + lane], &alo[r * kS + lane]);
          if (++r >= rb) break;
#pragma unroll
          for (int k = 0; k < 10; ++k) ring[k] = ring[k + 2];
          ring[10] = snake(up_at(xs, w0, T, 2 * (w0 + r) + 5), a, ib);
          ring[11] = snake(up_at(xs, w0, T, 2 * (w0 + r) + 6), a, ib);
        }
      }
    }
    if (j == 0) {
      __syncthreads();  // window written; xs free
      if (chunk + 1 < n_chunks) stage_x(c0 + kChunk);
    }
    if (step + 2 < n_steps) stage_w(step + 2);
    cp_commit();

    const float* wr = wring + (step % kStages) * TN * kS;

    const int n_k8 = min(kChunk, Cin - c0 + 7) / 8;
    for (int k8 = 0; k8 < n_k8; ++k8) {
      const int kc = k8 * 8 + t4;
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int o = (wn * NT * 8 + nt * 8 + g) * kS + kc;
        split(wr[o], &bh[nt][0], &bl[nt][0]);
        split(wr[o + 4], &bh[nt][1], &bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int o = (wm * MT * 16 + mt * 16 + g + j * dil) * kS + kc;
        const uint32_t ah[4] = {ahi[o], ahi[o + 8 * kS], ahi[o + 4],
                                ahi[o + 8 * kS + 4]};
        const uint32_t al[4] = {alo[o], alo[o + 8 * kS], alo[o + 4],
                                alo[o + 8 * kS + 4]};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          // small terms first, into a fresh sum that joins acc with a
          // float32 add: the tensor cores' own accumulation truncates, and
          // over K x Cin / 8 steps that drifts by more than float32 does
          float t[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(t, al, bh[nt]);
          mma_tf32(t, ah, bl[nt]);
          mma_tf32(t, ah, bh[nt]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += t[e];
        }
      }
    }
  }

  const size_t row0 = (size_t)b * T;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + wm * MT * 16 + mt * 16 + g + 8 * h;
      if (t >= T) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = n0 + wn * NT * 8 + nt * 8 + 2 * t4 + e;
          if (co >= Cout) continue;
          const size_t o = (row0 + t) * Cout + co;
          float v = acc[mt][nt][2 * h + e] + bias[co];
          if (res != nullptr) v += res[o];
          y[o] = v;
        }
      }
    }
  }
}

template <int WM, int WN, int MT, int NT>
int launch(const float* x, const float* alpha, const float* inv_beta,
           const float* w, const float* bias, const float* res, float* y,
           int B, int T, int Cin, int Cout, int K, int dil, int vec,
           cudaStream_t stream) {
  constexpr int TM = WM * MT * 16, TN = WN * NT * 8;
  auto kernel = snake_conv_kernel<WM, WN, MT, NT>;
  const size_t smem = smem_bytes(TM, TN, K, dil);
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  dim3 grid((T + TM - 1) / TM, (Cout + TN - 1) / TN, B);
  kernel<<<grid, WM * WN * 32, smem, stream>>>(x, alpha, inv_beta, w, bias,
                                               res, y, T, Cin, Cout, K, dil,
                                               vec);
  return (int)cudaGetLastError();
}

// Tile of a launch: the widest time tile that still gives a block per SM
// (TM 128, 64, then 32) with all of Cout in one block; at TM 32, Cout is
// split (down to 32 channels a block) until the card is full. 0 when the
// shape is not supported.
int choose_tile(int B, int T, int Cout, int K, int dil, int* tm, int* tn) {
  static int sms = 0, smem_max = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  }
  if (Cout < 1 || Cout > 128 || B < 1 || T < 1 || K < 1 || dil < 1) return 0;
  const int full = Cout <= 16 ? 16 : Cout <= 32 ? 32 : Cout <= 64 ? 64 : 128;
  *tm = 32;
  *tn = full;
  for (int m : {128, 64}) {
    if ((long)B * ((T + m - 1) / m) >= sms &&
        smem_bytes(m, full, K, dil) <= (size_t)smem_max) {
      *tm = m;
      break;
    }
  }
  if (*tm == 32) {
    const long t_tiles = (long)B * ((T + 31) / 32);
    while (*tn > 32 && t_tiles * ((Cout + *tn - 1) / *tn) < sms) *tn /= 2;
  }
  return smem_bytes(*tm, *tn, K, dil) <= (size_t)smem_max;
}

}  // namespace

extern "C" int snake_conv_tile(int B, int T, int Cout, int K, int dil,
                               int* tm, int* tn) {
  return choose_tile(B, T, Cout, K, dil, tm, tn) ? 0
                                                 : (int)cudaErrorInvalidValue;
}

// The float32 configuration (split TF32); the bf16 one is
// snake_conv_bf16_fwd (snake_conv_bf16.cu).
extern "C" int snake_conv_fwd(const float* x, const float* alpha,
                              const float* inv_beta, const float* w,
                              const float* bias, const float* res, float* y,
                              int B, int T, int Cin, int Cout, int K, int dil,
                              void* stream) {
  int tm, tn;
  if (Cin < 1 || !choose_tile(B, T, Cout, K, dil, &tm, &tn))
    return (int)cudaErrorInvalidValue;
  const int vec = Cin % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                  (uintptr_t)w % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
#define SNAKE_CONV_CASE(M, N, WM, WN, MT, NT)                              \
  if (tm == M && tn == N)                                                  \
    return launch<WM, WN, MT, NT>(x, alpha, inv_beta, w, bias, res, y, B, T, \
                                  Cin, Cout, K, dil, vec, s);
  SNAKE_CONV_CASE(128, 128, 2, 4, 4, 4)
  SNAKE_CONV_CASE(64, 128, 2, 4, 2, 4)
  SNAKE_CONV_CASE(32, 128, 2, 4, 1, 4)
  SNAKE_CONV_CASE(128, 64, 4, 2, 2, 4)
  SNAKE_CONV_CASE(64, 64, 4, 2, 1, 4)
  SNAKE_CONV_CASE(32, 64, 2, 4, 1, 2)
  SNAKE_CONV_CASE(128, 32, 4, 2, 2, 2)
  SNAKE_CONV_CASE(64, 32, 4, 2, 1, 2)
  SNAKE_CONV_CASE(32, 32, 2, 4, 1, 1)
  SNAKE_CONV_CASE(128, 16, 8, 1, 1, 2)
  SNAKE_CONV_CASE(64, 16, 4, 2, 1, 1)
  SNAKE_CONV_CASE(32, 16, 2, 2, 1, 1)
#undef SNAKE_CONV_CASE
  return (int)cudaErrorInvalidValue;
}
