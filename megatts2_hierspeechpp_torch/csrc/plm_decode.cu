// Greedy KV-cached decode of the prosody LM (ProsodyLM), B = 1, float32:
// the whole token loop in one persistent cooperative launch.
//
// Replaces megatts2_hierspeechpp_tpu/ops/pallas_plm_decode.py (_kernel, via
// plm_decode_greedy). Per token t: x = [tc_t | emb(prev)] + pos_alpha * pe_t,
// then per layer LN -> fused QKV -> causal attention over the cache ->
// out-proj -> residual -> LN -> FF(relu) -> residual, then logits and the
// first argmax, fed back as prev.
//
// What bounds it on the H100: one token is a chain of small matrix-vector
// products (15.9 MB of float32 weights, ~7.9 MFLOP) whose every phase
// depends on the one before. Launching per op costs ~70 launches per token;
// the TPU kernel's answer, weights resident in VMEM, has no counterpart
// (227 KB of shared memory per SM). Here the weights stay in device memory
// and are streamed through L2 (they fit its 50 MB) by all SMs at once, and
// the token loop runs inside one launch: one block per SM, phases separated
// by a grid-wide barrier (5 per layer + 1 per token), no host round trip.
//
// Phases of one layer, each ended by a grid barrier:
//   A  every block: x -> LayerNorm1 (recomputed per block, no extra
//      barrier); warps take QKV rows (one warp per output, row read as
//      float4); q -> scratch, k/v -> cache (L, T, 2, D)
//   B  blocks (head, key split): online softmax over their keys, partial
//      (m, l, acc[hd]) -> scratch
//   C  every block merges all partials into att[D]; warps take out-proj rows,
//      x[j] += Wo[j].att + bo[j]
//   D  every block: x -> LayerNorm2; warps take FF0 rows, h = relu(.)
//   E  warps take FF1 rows, x[j] += W1[j].h + b1[j]
// then logits: warps take rows of the (BINS, D) head, per-block first argmax
// -> scratch, barrier, every block reduces the partials the same way.
//
// The barrier is hand-rolled (one atomic counter, acquire loads), so the
// shared build needs no relocatable device code; cudaLaunchCooperativeKernel
// guarantees that all blocks are co-resident, which the barrier needs. A
// barrier that waits for seconds traps instead of hanging the card.
// Scratch written inside the launch is read with ld.global.cg (L2), never
// through L1.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 512;
constexpr int kMaxF = 2048;
constexpr int kMaxHd = 72;
constexpr int kMaxGrid = 132;
constexpr int kMaxParts = 128;              // attention partials: head x split
constexpr int kPartStride = kMaxHd + 2;     // m, l, acc[hd]
constexpr int kMinKeys = 32;                // keys per split, at least
constexpr int kBuf = kMaxParts * kPartStride > kMaxF ? kMaxParts * kPartStride
                                                     : kMaxF;
constexpr long long kSpinLimit = 1LL << 34;  // clock cycles, ~9 s
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* tc;    // (T, TC)
  const float* pe;    // (T, D) pos_alpha * sine table
  const float* emb;   // (V, D - TC)
  const float* wqkv;  // (L, 3D, D)
  const float* bqkv;  // (L, 3D)
  const float* wo;    // (L, D, D)
  const float* bo;    // (L, D)
  const float* ln;    // (L, 4, D): norm1 w, b, norm2 w, b
  const float* ff0;   // (L, F, D)
  const float* ff0b;  // (L, F)
  const float* ff1;   // (L, D, F)
  const float* ff1b;  // (L, D)
  const float* pred;  // (BINS, D)
  float* cache;       // (L, T, 2, D)
  float* scratch;     // x[D] q[D] h[F] parts[kMaxParts*kPartStride] lval[kMaxGrid]
  int* iscratch;      // barrier counter (zeroed), lidx[kMaxGrid]
  int* codes;         // (T,)
  int T, L, D, TC, H, F, BINS, go_id;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// (v, i) beats (bv, bi) when larger, or equal with a lower index: the first
// argmax, whatever order the candidates come in.
__device__ __forceinline__ void better(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// Block-wide sum; every thread gets it. red: kWarps floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// Block-wide first argmax; every thread gets it.
__device__ __forceinline__ void block_argmax(float& bv, int& bi, float* sv,
                                             int* si) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    better(bv, bi, __shfl_xor_sync(kFull, bv, o),
           __shfl_xor_sync(kFull, bi, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    sv[threadIdx.x >> 5] = bv;
    si[threadIdx.x >> 5] = bi;
  }
  __syncthreads();
  bv = sv[0];
  bi = si[0];
  for (int w = 1; w < kWarps; ++w) better(bv, bi, sv[w], si[w]);
}

// dot(w[0:4*n4], v[0:4*n4]) by one warp; w in device memory (read-only),
// v in shared memory, both 16-byte aligned. Every lane gets the sum.
__device__ __forceinline__ float warp_dot(const float* __restrict__ w,
                                          const float* v, int n4, int lane) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
  const float4* v4 = reinterpret_cast<const float4*>(v);
  float s = 0.f;
  for (int i = lane; i < n4; i += 32) {
    const float4 a = __ldg(w4 + i);
    const float4 b = v4[i];
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
    s = fmaf(a.z, b.z, s);
    s = fmaf(a.w, b.w, s);
  }
  return warp_sum(s);
}

// LayerNorm (eps 1e-5) of xs[0:D] into yn, by the whole block.
__device__ __forceinline__ void layer_norm(const float* xs, float* yn,
                                           const float* w, const float* b,
                                           int D, float* red) {
  float s = 0.f;
  for (int j = threadIdx.x; j < D; j += kThreads) s += xs[j];
  const float mean = block_sum(s, red) / D;
  float q = 0.f;
  for (int j = threadIdx.x; j < D; j += kThreads) {
    const float d = xs[j] - mean;
    q = fmaf(d, d, q);
  }
  const float rstd = rsqrtf(block_sum(q, red) / D + 1e-5f);
  for (int j = threadIdx.x; j < D; j += kThreads)
    yn[j] = (xs[j] - mean) * rstd * __ldg(w + j) + __ldg(b + j);
  __syncthreads();
}

// Grid-wide barrier over a monotonic counter (target grows by gridDim.x per
// call). Traps if the other blocks do not arrive within kSpinLimit cycles.
__device__ __forceinline__ void grid_sync(unsigned int* bar,
                                          unsigned int& target) {
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    const long long t0 = clock64();
    unsigned int v;
    while (true) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(v)
                   : "l"(bar)
                   : "memory");
      if (static_cast<int>(v - target) >= 0) break;
      if (clock64() - t0 > kSpinLimit) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
plm_decode_kernel(const Args a) {
  __shared__ __align__(16) float xs[kMaxD];
  __shared__ __align__(16) float yn[kMaxD];
  __shared__ __align__(16) float att[kMaxD];
  __shared__ __align__(16) float buf[kBuf];  // partials / h / warp states
  __shared__ float qs[kMaxHd];
  __shared__ float red[kWarps];
  __shared__ float wm[kWarps];
  __shared__ float wl[kWarps];
  __shared__ int wi[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // warp-major: output row j goes to block j % grid, so every SM streams
  // its share of each weight matrix
  const int gw = warp * gridDim.x + blockIdx.x;
  const int nw = gridDim.x * kWarps;
  const int D = a.D, F = a.F, H = a.H, T = a.T, TC = a.TC;
  const int hd = D / H, VQ = D - TC;
  const float sq = sqrtf(static_cast<float>(hd));
  float* xbuf = a.scratch;
  float* qbuf = xbuf + D;
  float* hbuf = qbuf + D;
  float* parts = hbuf + F;
  float* lval = parts + kMaxParts * kPartStride;
  unsigned int* bar = reinterpret_cast<unsigned int*>(a.iscratch);
  int* lidx = a.iscratch + 1;
  unsigned int target = 0;
  int prev = a.go_id;

  for (int t = 0; t < T; ++t) {
    const int n_keys = t + 1;
    int nsplit = (n_keys + kMinKeys - 1) / kMinKeys;
    nsplit = min(nsplit, min(kMaxParts / H, static_cast<int>(gridDim.x) / H));
    nsplit = max(nsplit, 1);
    const int per = (n_keys + nsplit - 1) / nsplit;

    for (int i = 0; i < a.L; ++i) {
      const float* ln = a.ln + static_cast<size_t>(i) * 4 * D;
      float* kv = a.cache + static_cast<size_t>(i) * T * 2 * D;  // (T, 2, D)

      // ---- A: LayerNorm1 + QKV; k/v of this token into the cache ----
      if (i == 0) {
        for (int j = tid; j < D; j += kThreads) {
          float v = j < TC ? __ldg(a.tc + static_cast<size_t>(t) * TC + j)
                           : __ldg(a.emb + static_cast<size_t>(prev) * VQ +
                                   (j - TC));
          v += __ldg(a.pe + static_cast<size_t>(t) * D + j);
          xs[j] = v;
          if (blockIdx.x == 0) xbuf[j] = v;
        }
      } else {
        for (int j = tid; j < D; j += kThreads) xs[j] = __ldcg(xbuf + j);
      }
      __syncthreads();
      layer_norm(xs, yn, ln, ln + D, D, red);
      {
        const float* w = a.wqkv + static_cast<size_t>(i) * 3 * D * D;
        const float* b = a.bqkv + static_cast<size_t>(i) * 3 * D;
        for (int j = gw; j < 3 * D; j += nw) {
          const float v =
              warp_dot(w + static_cast<size_t>(j) * D, yn, D / 4, lane) +
              __ldg(b + j);
          if (lane == 0) {
            if (j < D)
              qbuf[j] = v;
            else  // k at [t, 0, :], v at [t, 1, :]
              kv[static_cast<size_t>(t) * 2 * D + (j - D)] = v;
          }
        }
      }
      grid_sync(bar, target);

      // ---- B: attention partials, block = (head, key split) ----
      if (blockIdx.x < H * nsplit) {
        const int h = blockIdx.x % H, s = blockIdx.x / H;
        const int k0 = s * per, k1 = min(n_keys, k0 + per);
        for (int d = tid; d < hd; d += kThreads) qs[d] = __ldcg(qbuf + h * hd + d);
        __syncthreads();
        float m = -INFINITY, l = 0.f, acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
        for (int key = k0 + warp; key < k1; key += kWarps) {
          const float* kp = kv + static_cast<size_t>(key) * 2 * D + h * hd;
          const float* vp = kp + D;
          float p = 0.f;
          if (lane < hd) p = qs[lane] * __ldcg(kp + lane);
          if (lane + 32 < hd) p = fmaf(qs[lane + 32], __ldcg(kp + lane + 32), p);
          if (lane + 64 < hd) p = fmaf(qs[lane + 64], __ldcg(kp + lane + 64), p);
          const float sc = warp_sum(p) / sq;
          const float mn = fmaxf(m, sc);
          const float corr = expf(m - mn), e = expf(sc - mn);
          l = l * corr + e;
          if (lane < hd) acc0 = acc0 * corr + e * __ldcg(vp + lane);
          if (lane + 32 < hd) acc1 = acc1 * corr + e * __ldcg(vp + lane + 32);
          if (lane + 64 < hd) acc2 = acc2 * corr + e * __ldcg(vp + lane + 64);
          m = mn;
        }
        float* wacc = buf;  // (kWarps, kMaxHd)
        if (lane == 0) {
          wm[warp] = m;
          wl[warp] = l;
        }
        if (lane < hd) wacc[warp * kMaxHd + lane] = acc0;
        if (lane + 32 < hd) wacc[warp * kMaxHd + lane + 32] = acc1;
        if (lane + 64 < hd) wacc[warp * kMaxHd + lane + 64] = acc2;
        __syncthreads();
        float M = -INFINITY;
        for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w]);
        float* out = parts + static_cast<size_t>(h * nsplit + s) * kPartStride;
        for (int d = tid; d < hd; d += kThreads) {
          float acc = 0.f;
          for (int w = 0; w < kWarps; ++w)
            if (wm[w] > -INFINITY) acc += wacc[w * kMaxHd + d] * expf(wm[w] - M);
          out[2 + d] = acc;
        }
        if (tid == 0) {
          float lsum = 0.f;
          for (int w = 0; w < kWarps; ++w)
            if (wm[w] > -INFINITY) lsum += wl[w] * expf(wm[w] - M);
          out[0] = M;
          out[1] = lsum;
        }
      }
      grid_sync(bar, target);

      // ---- C: merge partials -> att; out-proj + residual ----
      {
        const int n = H * nsplit * (hd + 2);
        for (int idx = tid; idx < n; idx += kThreads) {
          const int p = idx / (hd + 2), f = idx % (hd + 2);
          buf[p * kPartStride + f] = __ldcg(parts + p * kPartStride + f);
        }
        __syncthreads();
        for (int c = tid; c < D; c += kThreads) {
          const float* pb = buf + (c / hd) * nsplit * kPartStride;
          const int d = c % hd;
          float M = -INFINITY;
          for (int s = 0; s < nsplit; ++s) M = fmaxf(M, pb[s * kPartStride]);
          float lsum = 0.f, acc = 0.f;
          for (int s = 0; s < nsplit; ++s) {
            const float e = expf(pb[s * kPartStride] - M);
            lsum += pb[s * kPartStride + 1] * e;
            acc += pb[s * kPartStride + 2 + d] * e;
          }
          att[c] = acc / lsum;
        }
        __syncthreads();
        const float* w = a.wo + static_cast<size_t>(i) * D * D;
        for (int j = gw; j < D; j += nw) {
          const float v =
              warp_dot(w + static_cast<size_t>(j) * D, att, D / 4, lane) +
              __ldg(a.bo + i * D + j);
          if (lane == 0) xbuf[j] = __ldcg(xbuf + j) + v;
        }
      }
      grid_sync(bar, target);

      // ---- D: LayerNorm2 + FF0 + relu ----
      for (int j = tid; j < D; j += kThreads) xs[j] = __ldcg(xbuf + j);
      __syncthreads();
      layer_norm(xs, yn, ln + 2 * D, ln + 3 * D, D, red);
      {
        const float* w = a.ff0 + static_cast<size_t>(i) * F * D;
        for (int j = gw; j < F; j += nw) {
          const float v =
              warp_dot(w + static_cast<size_t>(j) * D, yn, D / 4, lane) +
              __ldg(a.ff0b + i * F + j);
          if (lane == 0) hbuf[j] = fmaxf(v, 0.f);
        }
      }
      grid_sync(bar, target);

      // ---- E: FF1 + residual ----
      for (int j = tid; j < F; j += kThreads) buf[j] = __ldcg(hbuf + j);
      __syncthreads();
      {
        const float* w = a.ff1 + static_cast<size_t>(i) * D * F;
        for (int j = gw; j < D; j += nw) {
          const float v =
              warp_dot(w + static_cast<size_t>(j) * F, buf, F / 4, lane) +
              __ldg(a.ff1b + i * D + j);
          if (lane == 0) xbuf[j] = __ldcg(xbuf + j) + v;
        }
      }
      grid_sync(bar, target);
    }

    // ---- logits and the first argmax ----
    for (int j = tid; j < D; j += kThreads) xs[j] = __ldcg(xbuf + j);
    __syncthreads();
    float bv = -INFINITY;
    int bi = a.BINS;
    for (int j = gw; j < a.BINS; j += nw) {
      const float v = warp_dot(a.pred + static_cast<size_t>(j) * D, xs, D / 4, lane);
      better(bv, bi, v, j);
    }
    block_argmax(bv, bi, wm, wi);
    if (tid == 0) {
      lval[blockIdx.x] = bv;
      lidx[blockIdx.x] = bi;
    }
    grid_sync(bar, target);
    bv = -INFINITY;
    bi = a.BINS;
    for (int b = tid; b < static_cast<int>(gridDim.x); b += kThreads)
      better(bv, bi, __ldcg(lval + b), __ldcg(lidx + b));
    block_argmax(bv, bi, wm, wi);
    prev = bi < a.BINS ? bi : 0;
    if (blockIdx.x == 0 && tid == 0) a.codes[t] = prev;
  }
}

}  // namespace

extern "C" int plm_decode_fwd(const float* tc, const float* pe,
                              const float* emb, const float* wqkv,
                              const float* bqkv, const float* wo,
                              const float* bo, const float* ln,
                              const float* ff0, const float* ff0b,
                              const float* ff1, const float* ff1b,
                              const float* pred, float* cache, float* scratch,
                              int* iscratch, int* codes, int T, int L, int D,
                              int TC, int H, int F, int BINS, int go_id,
                              void* stream) {
  if (T < 1 || L < 1 || H < 1 || D > kMaxD || F > kMaxF || D % 4 || F % 4 ||
      D % H || D / H > kMaxHd || TC < 0 || TC >= D || H > kMaxParts)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, plm_decode_kernel,
                                                    kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop || per_sm < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int grid = sms < kMaxGrid ? sms : kMaxGrid;
  if (grid < H) return static_cast<int>(cudaErrorInvalidValue);
  Args a{tc,   pe,   emb,  wqkv, bqkv,  wo,    bo, ln, ff0,  ff0b, ff1,   ff1b,
         pred, cache, scratch, iscratch, codes, T, L,  D,    TC,   H,     F,
         BINS, go_id};
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(plm_decode_kernel),
                                  dim3(grid), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
