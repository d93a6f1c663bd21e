// Greedy KV-cached decode of the prosody LM (ProsodyLM), B = 1, float32:
// the whole token loop in one persistent cooperative launch.
//
// Replaces megatts2_hierspeechpp_tpu/ops/pallas_plm_decode.py (_kernel, via
// plm_decode_greedy). Per token t: x = [tc_t | emb(prev)] + pos_alpha * pe_t,
// then per layer LN -> fused QKV -> causal attention over the cache ->
// out-proj -> residual -> LN -> FF(relu) -> residual, then logits and the
// first argmax, fed back as prev.
//
// What bounds it on the H100: one token is a chain of 21 small dependent
// matrix-vector phases (15.8 MB of float32 matrices, ~7.9 MFLOP), so the
// limit is latency, not bytes or flops. Two parts of the design answer it:
//
// * Weights resident in shared memory, spread over the grid (the TPU kernel
//   kept them in VMEM). Block b owns the output rows j = b (mod grid) of
//   every matrix (wqkv, wo, ff0, ff1 of every layer, and pred); at the start
//   of the launch it copies them once into dynamic shared memory with 1-D
//   bulk async copies (cp.async.bulk, completion on an mbarrier), with the
//   LayerNorm weights (every block recomputes the LayerNorms). 132 blocks of
//   ~180 KB hold all 15.8 MB. Every matrix-vector product then reads its
//   rows from shared memory. A plan that does not fit the card's shared
//   memory is refused (the wrapper raises); there is no streaming fallback.
//
// * Handoffs carried in the data, in place of a grid barrier between
//   phases. Every value a phase publishes for other blocks is one 64-bit
//   {float value, uint32 epoch} store (as NCCL's LL protocol does); a
//   consumer polls the pairs it reads until each carries the epoch of the
//   current (token, layer, phase), then uses the value it polled. A block
//   waits only on what it reads: an attention block on q, k and v of its
//   head; every other phase on the whole vector it reads. A block's argmax
//   partial is two such pairs in one 16-byte store, taken when both carry
//   the epoch.
//
// Phases of one layer (epoch e0 + 5 i + 0..4):
//   A  x (polled, or built from tc/emb/pe at layer 0) -> LayerNorm1 in every
//      block; warps take the block's QKV rows; q, k, v published, k/v also
//      stored to the cache (L, T, 2, D) with plain stores
//   B  blocks (head, key split): softmax partial (m, l, acc[hd]) over their
//      keys, staged from the cache 32 keys at a time; this token's k/v come
//      from the pairs
//   C  every block merges all partials (fixed order) into att[D]; out-proj
//      rows: x[j] + Wo[j].att + bo[j] published
//   D  x polled -> LayerNorm2; FF0 rows: h = relu(.) published
//   E  h polled; FF1 rows: x[j] + W1[j].h + b1[j] published
// then logits rows and each block's first argmax published (epoch e0 + 5L);
// at the start of the next token every block polls all of them and reduces
// them the same way. No float atomics; every sum runs in a fixed order, so
// the codes are the same from run to run.
//
// Hazards, and what handles each:
// * Stale epochs from an earlier launch: the wrapper zeroes the exchange
//   buffer before every launch (torch.zeros on the same stream); epochs
//   start at 1, so no pair left from an earlier call or token matches.
// * Write after read across tokens: every exchange array exists per layer
//   and per phase, twice, by token parity. A pair of parity t & 1 is next
//   written at token t + 2. Its writer has by then polled every block's
//   argmax partial of token t + 1, and each block publishes that partial
//   after all its reads of token t (and after a fence), so no reader of
//   token t can still be waiting on the pair.
// * Plain stores: the KV cache takes plain float32 stores. Token t's
//   entries are read from token t + 1 on, after the argmax handoff of token
//   t: each block's argmax publisher fences (after a block barrier) between
//   the block's cache stores and its argmax store, and every reader loads
//   the argmax pairs with acquire semantics, as the single-counter grid
//   barrier's two fences did. Cache and exchange are read through L2
//   (ld.global.cg, ld.volatile), never L1.
// * A wait that lasts for seconds traps instead of hanging the card.
//
// An optional stamps buffer takes block 0's clock twice per phase: when it
// has published its outputs, and when it holds the outputs of the phase
// that it reads next (see stamp).
// plm_barrier_probe times, alone, the single-counter grid barrier that the
// kernel ran between phases before its handoffs carried flags.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGrid = 132;
constexpr int kMaxParts = 128;   // attention partials: head x split
constexpr int kMinKeys = 32;     // keys per split, at least
constexpr int kKeyChunk = 32;    // keys staged in shared memory at a time
constexpr int kStageRegs = 5;    // per thread: the first chunk's k, v in flight
constexpr long long kSpinLimit = 1LL << 34;  // clock cycles, ~9 s
constexpr unsigned kFull = 0xffffffffu;
typedef unsigned long long u64;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int up4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// Layout of one block's dynamic shared memory (floats) and of the exchange
// buffer (pairs), computed the same way here and by ops/plm_decode.py
// (smem_plan), which passes its byte and pair counts for a check.
struct Plan {
  int cq, co, c0, c1, cp;           // row slots per block: wqkv wo ff0 ff1 pred
  int o_wo, o_ff0, o_ff1, w_layer;  // in one layer's weights (wqkv at 0)
  int o_pred, o_ln, o_bias, n_bias, o_x, o_yn, o_att, o_work;
  int bytes;                        // dynamic shared memory
  int nsplit_max;
  int x_parts, x_xc, x_h, x_xe, x_layer, x_arg, x_parity, x_total;
};

__host__ __device__ inline Plan make_plan(int D, int F, int L, int BINS, int H,
                                          int G) {
  Plan p;
  p.cq = cdiv(3 * D, G);
  p.co = cdiv(D, G);
  p.c0 = cdiv(F, G);
  p.c1 = cdiv(D, G);
  p.cp = cdiv(BINS, G);
  p.o_wo = p.cq * D;
  p.o_ff0 = p.o_wo + p.co * D;
  p.o_ff1 = p.o_ff0 + p.c0 * D;
  p.w_layer = p.o_ff1 + p.c1 * F;
  p.o_pred = L * p.w_layer;
  p.o_ln = p.o_pred + p.cp * D;
  p.o_bias = p.o_ln + L * 4 * D;
  p.n_bias = p.cq + p.co + p.c0 + p.c1;  // per layer
  p.o_x = p.o_bias + up4(L * p.n_bias);
  p.o_yn = p.o_x + up4(D);
  p.o_att = p.o_yn + up4(D);
  p.o_work = p.o_att + up4(D);
  const int hd = D / H;
  p.nsplit_max = imax(1, imin(kMaxParts / H, G / H));
  // work: h (E); keys, values, scores, weights, q (B); partials, weights,
  // sums (C)
  const int attn = 2 * kKeyChunk * hd + 2 * kKeyChunk + up4(hd);
  const int merge = H * p.nsplit_max * (hd + 3) + H;
  p.bytes = 4 * (p.o_work + up4(imax(F, imax(attn, merge))));
  p.x_parts = 3 * D;  // qkv at 0
  p.x_xc = p.x_parts + H * p.nsplit_max * (hd + 2);
  p.x_h = p.x_xc + D;
  p.x_xe = p.x_h + F;
  p.x_layer = p.x_xe + D;
  p.x_arg = L * p.x_layer;  // 2 pairs per block
  p.x_parity = p.x_arg + 2 * G;
  p.x_total = 2 * p.x_parity;
  return p;
}

// rows of a matrix of R rows that block b of G owns
__host__ __device__ inline int owned(int R, int b, int G) {
  return R > b ? (R - 1 - b) / G + 1 : 0;
}

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
  u64* xch;           // exchange pairs, zeroed (Plan::x_total)
  int* codes;         // (T,)
  u64* stamps;        // (T, 5L + 1, 3) or null
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

// dot(w[0:4*n4], v[0:4*n4]) by one warp, both in shared memory, 16-byte
// aligned. Every lane gets the sum.
__device__ __forceinline__ float warp_dot(const float* w, const float* v,
                                          int n4, int lane) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
  const float4* v4 = reinterpret_cast<const float4*>(v);
  float s = 0.f;
  for (int i = lane; i < n4; i += 32) {
    const float4 a = w4[i];
    const float4 b = v4[i];
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
    s = fmaf(a.z, b.z, s);
    s = fmaf(a.w, b.w, s);
  }
  return warp_sum(s);
}

// LayerNorm (eps 1e-5) of xs[0:D] into yn, by the whole block. Warp 0
// computes the statistics (two passes) while the others wait: when every
// warp computed them, their issue slots made it twice as slow. stat: 2 floats.
__device__ __forceinline__ void layer_norm(const float* xs, float* yn,
                                           const float* w, const float* b,
                                           int D, float* stat) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float s = 0.f;
    for (int j = lane; j < D; j += 32) s += xs[j];
    const float mean = warp_sum(s) / D;
    float q = 0.f;
    for (int j = lane; j < D; j += 32) {
      const float d = xs[j] - mean;
      q = fmaf(d, d, q);
    }
    const float rstd = rsqrtf(warp_sum(q) / D + 1e-5f);
    if (lane == 0) {
      stat[0] = mean;
      stat[1] = rstd;
    }
  }
  __syncthreads();
  const float mean = stat[0], rstd = stat[1];
  for (int j = threadIdx.x; j < D; j += kThreads)
    yn[j] = (xs[j] - mean) * rstd * w[j] + b[j];
  __syncthreads();
}

// ---- flag-carried pairs ----

__device__ __forceinline__ u64 ld_pair(const u64* p) {
  u64 v;
  asm volatile("ld.volatile.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_pair(u64* p, float v, unsigned e) {
  const u64 x = (static_cast<u64>(e) << 32) | __float_as_uint(v);
  asm volatile("st.volatile.global.u64 [%0], %1;" ::"l"(p), "l"(x) : "memory");
}

__device__ __forceinline__ unsigned epoch_of(u64 v) {
  return static_cast<unsigned>(v >> 32);
}

// Spin until pair p carries epoch e; its value. Out of line: the code of
// the token loop is kept small enough for the instruction cache.
__device__ __noinline__ float spin_pair(const u64* p, unsigned e) {
  const long long t0 = clock64();
  u64 v;
  do {
    v = ld_pair(p);
    if (clock64() - t0 > kSpinLimit) __trap();
  } while (epoch_of(v) != e);
  return __uint_as_float(static_cast<unsigned>(v));
}

// The value of pair p once it carries epoch e; v is a first load of it.
__device__ __forceinline__ float wait_pair(const u64* p, u64 v, unsigned e) {
  return epoch_of(v) == e ? __uint_as_float(static_cast<unsigned>(v))
                          : spin_pair(p, e);
}

// loads in flight per thread in poll (8 took 3 ms longer for 500 tokens on
// an H100: more code in the token loop)
constexpr int kPollDepth = 4;

// dst[i] = the value of src[i] for i < n, each once it carries epoch e; the
// whole block, kPollDepth loads in flight per thread. Starts with a barrier
// (dst may still be read by the phase before) and ends with one.
__device__ __forceinline__ void poll(const u64* src, float* dst, int n,
                                     unsigned e) {
  __syncthreads();
  for (int base = threadIdx.x; base < n; base += kPollDepth * kThreads) {
    u64 v[kPollDepth];
#pragma unroll
    for (int k = 0; k < kPollDepth; ++k)
      v[k] = base + k * kThreads < n ? ld_pair(src + base + k * kThreads) : 0;
#pragma unroll
    for (int k = 0; k < kPollDepth; ++k) {
      const int i = base + k * kThreads;
      if (i < n) dst[i] = wait_pair(src + i, v[k], e);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// Every block: the first argmax over all blocks' partials (2 pairs each),
// each read with acquire semantics, so the cache stores made before them
// are visible. Returns the code.
__device__ __forceinline__ int poll_argmax(const u64* arg, unsigned e, int BINS,
                                           float* sv, int* si) {
  float bv = -INFINITY;
  int bi = BINS;
  if (threadIdx.x < gridDim.x) {
    const u64* q = arg + 2 * threadIdx.x;
    u64 v0, v1;
    const long long t0 = clock64();
    while (true) {  // the acquire load orders the later cache reads
      asm volatile("ld.volatile.global.u64 %0, [%1];" : "=l"(v0) : "l"(q) : "memory");
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                   : "=l"(v1)
                   : "l"(q + 1)
                   : "memory");
      if (epoch_of(v0) == e && epoch_of(v1) == e) break;
      if (clock64() - t0 > kSpinLimit) __trap();
    }
    better(bv, bi, __uint_as_float(static_cast<unsigned>(v0)),
           static_cast<int>(static_cast<unsigned>(v1)));
  }
  block_argmax(bv, bi, sv, si);
  return bi < BINS ? bi : 0;
}

// Block 0's clocks at phase k: its SM cycle counter when it has published
// the phase's outputs (column 0) and when it holds the outputs of the phase
// that it reads next (column 1); at the logits (wall) also %globaltimer
// (column 2), which moves in coarse steps on the H100: it only converts
// cycles to seconds over the launch.
__device__ __forceinline__ void stamp(u64* stamps, int k, int ready,
                                      bool wall = false) {
  if (stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    u64 c;  // "memory": not moved across the barriers around it
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(c)::"memory");
    stamps[3 * k + ready] = c;
    if (wall) {
      u64 ns;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns)::"memory");
      stamps[3 * k + 2] = ns;
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 1-D bulk async copy global -> shared, completion on the mbarrier at mb.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          int bytes, uint32_t mb) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(mb)
      : "memory");
}

// The earlier design's grid barrier: one monotonic counter (target grows by
// gridDim.x per call). Kept only for plm_barrier_probe.
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

// n grid barriers and no work, on the decode kernel's grid and block size.
__global__ void __launch_bounds__(kThreads, 1)
barrier_probe_kernel(unsigned int* bar, int n) {
  unsigned int target = 0;
  for (int i = 0; i < n; ++i) grid_sync(bar, target);
}

__global__ void __launch_bounds__(kThreads, 1)
plm_decode_kernel(const Args a) {
  extern __shared__ __align__(128) float sm[];
  __shared__ __align__(8) u64 mbar;
  __shared__ float wv[kWarps];
  __shared__ int wi[kWarps];
  __shared__ float lstat[2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, b = blockIdx.x;
  const int D = a.D, F = a.F, H = a.H, T = a.T, TC = a.TC, L = a.L;
  const int hd = D / H, VQ = D - TC, per_tok = 5 * L + 1;
  const float sq = sqrtf(static_cast<float>(hd));
  const Plan p = make_plan(D, F, L, a.BINS, H, G);
  float* xs = sm + p.o_x;
  float* yn = sm + p.o_yn;
  float* att = sm + p.o_att;
  float* work = sm + p.o_work;
  const float* lnw = sm + p.o_ln;
  float* bias = sm + p.o_bias;

  // ---- this block's rows (j = slot * G + b) into shared memory, once ----
  const uint32_t mb = smem_addr(&mbar);
  if (warp == 0) {
    if (lane == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(mb) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      const int rows_d = L * (owned(3 * D, b, G) + owned(D, b, G) +
                              owned(F, b, G)) + owned(a.BINS, b, G);
      const uint32_t total =
          4u * (rows_d * D + L * owned(D, b, G) * F + L * 4 * D);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(mb), "r"(total) : "memory");
    }
    __syncwarp();
    int k = 0;  // copies dealt round-robin over the lanes
    auto copy = [&](float* dst, const float* src, int bytes) {
      if ((k++ & 31) == lane) bulk_copy(dst, src, bytes, mb);
    };
    for (int i = 0; i < L; ++i) {
      float* wl = sm + i * p.w_layer;
      for (int s = 0; s * G + b < 3 * D; ++s)
        copy(wl + s * D,
             a.wqkv + (static_cast<size_t>(i) * 3 * D + s * G + b) * D, 4 * D);
      for (int s = 0; s * G + b < D; ++s)
        copy(wl + p.o_wo + s * D,
             a.wo + (static_cast<size_t>(i) * D + s * G + b) * D, 4 * D);
      for (int s = 0; s * G + b < F; ++s)
        copy(wl + p.o_ff0 + s * D,
             a.ff0 + (static_cast<size_t>(i) * F + s * G + b) * D, 4 * D);
      for (int s = 0; s * G + b < D; ++s)
        copy(wl + p.o_ff1 + s * F,
             a.ff1 + (static_cast<size_t>(i) * D + s * G + b) * F, 4 * F);
    }
    for (int s = 0; s * G + b < a.BINS; ++s)
      copy(sm + p.o_pred + s * D, a.pred + static_cast<size_t>(s * G + b) * D,
           4 * D);
    copy(sm + p.o_ln, a.ln, 4 * L * 4 * D);
  }
  // biases of the owned rows, per layer [wqkv | wo | ff0 | ff1] slots
  for (int idx = tid; idx < L * p.n_bias; idx += kThreads) {
    const int i = idx / p.n_bias;
    int s = idx % p.n_bias;
    float v = 0.f;
    if (s < p.cq) {
      if (s * G + b < 3 * D) v = a.bqkv[i * 3 * D + s * G + b];
    } else if ((s -= p.cq) < p.co) {
      if (s * G + b < D) v = a.bo[i * D + s * G + b];
    } else if ((s -= p.co) < p.c0) {
      if (s * G + b < F) v = a.ff0b[i * F + s * G + b];
    } else if ((s -= p.c0) * G + b < D) {
      v = a.ff1b[i * D + s * G + b];
    }
    bias[idx] = v;
  }
  __syncthreads();
  {
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{ .reg .pred P; mbarrier.try_wait.parity.shared::cta.b64 P, [%1], 0;"
          " selp.u32 %0, 1, 0, P; }"
          : "=r"(done)
          : "r"(mb)
          : "memory");
  }

  int prev = a.go_id;
  for (int t = 0; t < T; ++t) {
    u64* X = a.xch + static_cast<size_t>(t & 1) * p.x_parity;
    const unsigned e0 = static_cast<unsigned>(t) * per_tok + 1;
    const int st0 = t * per_tok;
    const int n_keys = t + 1;
    const int nsplit = imax(1, imin(cdiv(n_keys, kMinKeys), p.nsplit_max));
    const int per = cdiv(n_keys, nsplit);

    // this token's tc and pe, loaded before the wait on the last code
    float xin = 0.f;
    if (tid < D)
      xin = (tid < TC ? __ldg(a.tc + static_cast<size_t>(t) * TC + tid) : 0.f) +
            __ldg(a.pe + static_cast<size_t>(t) * D + tid);
    if (t > 0) {
      prev = poll_argmax(
          a.xch + static_cast<size_t>((t - 1) & 1) * p.x_parity + p.x_arg,
          e0 - 1, a.BINS, wv, wi);
      stamp(a.stamps, st0 - 1, 1, true);
      if (b == 0 && tid == 0) a.codes[t - 1] = prev;
    }

    for (int i = 0; i < L; ++i) {
      u64* XL = X + i * p.x_layer;
      const float* wl = sm + i * p.w_layer;
      const float* bl = bias + i * p.n_bias;
      const float* ln = lnw + i * 4 * D;
      const unsigned e = e0 + 5 * i;
      const int st = st0 + 5 * i;
      float* kv = a.cache + static_cast<size_t>(i) * T * 2 * D;  // (T, 2, D)

      // ---- A: LayerNorm1 + QKV; q, k, v published, k/v into the cache ----
      if (i == 0) {
        if (tid < D)  // [tc | emb(prev)] + pe
          xs[tid] = tid < TC ? xin
                             : __ldg(a.emb + static_cast<size_t>(prev) * VQ +
                                     (tid - TC)) + xin;
        __syncthreads();
      } else {
        poll(XL - p.x_layer + p.x_xe, xs, D, e - 1);
        stamp(a.stamps, st - 1, 1);
      }
      layer_norm(xs, yn, ln, ln + D, D, lstat);
      for (int s = warp; s * G + b < 3 * D; s += kWarps) {
        const int j = s * G + b;
        const float v = warp_dot(wl + s * D, yn, D / 4, lane) + bl[s];
        if (lane == 0) {
          if (j >= D)  // k at [t, 0, :], v at [t, 1, :]
            kv[static_cast<size_t>(t) * 2 * D + (j - D)] = v;
          st_pair(XL + j, v, e);
        }
      }
      stamp(a.stamps, st, 0);

      // ---- B: attention partials, block = (head, key split) ----
      if (b < H * nsplit) {
        const int h = b % H, s = b / H;
        const int k0 = s * per, k1 = imin(n_keys, k0 + per);
        float* ks = work;  // (kKeyChunk, hd)
        float* vs = ks + kKeyChunk * hd;
        float* sc = vs + kKeyChunk * hd;
        float* pw = sc + kKeyChunk;
        float* qs = pw + kKeyChunk;
        // Keys before this token come from the cache (written at earlier
        // tokens). The first chunk's loads are issued into registers before
        // the wait on q, so their L2 round trip overlaps it.
        const int n_first = imin(kKeyChunk, k1 - k0);
        const bool early = n_first * hd <= kStageRegs * kThreads;
        float kr[kStageRegs], vr[kStageRegs];
#pragma unroll
        for (int r = 0; r < kStageRegs; ++r) {
          const int idx = tid + r * kThreads, key = k0 + idx / hd;
          kr[r] = vr[r] = 0.f;
          if (early && idx < n_first * hd && key < t) {
            const float* kp =
                kv + static_cast<size_t>(key) * 2 * D + h * hd + idx % hd;
            kr[r] = __ldcg(kp);
            vr[r] = __ldcg(kp + D);
          }
        }
        poll(XL + h * hd, qs, hd, e);
        stamp(a.stamps, st, 1);
        float m = -INFINITY, l = 0.f, acc = 0.f;
        for (int c0 = k0; c0 < k1; c0 += kKeyChunk) {
          const int n = imin(kKeyChunk, k1 - c0);
          if (c0 == k0 && early) {
#pragma unroll
            for (int r = 0; r < kStageRegs; ++r) {
              const int idx = tid + r * kThreads;
              if (idx < n * hd && k0 + idx / hd < t) {
                ks[idx] = kr[r];
                vs[idx] = vr[r];
              }
            }
          } else {
            for (int idx = tid; idx < n * hd; idx += kThreads) {
              const int key = c0 + idx / hd, d = idx % hd;
              if (key < t) {
                const float* kp =
                    kv + static_cast<size_t>(key) * 2 * D + h * hd + d;
                ks[idx] = __ldcg(kp);
                vs[idx] = __ldcg(kp + D);
              }
            }
          }
          if (c0 + n - 1 == t && tid < hd) {  // this token's key: the pairs
            const u64* kp = XL + D + h * hd + tid;
            const u64 kv0 = ld_pair(kp), kv1 = ld_pair(kp + D);
            ks[(n - 1) * hd + tid] = wait_pair(kp, kv0, e);
            vs[(n - 1) * hd + tid] = wait_pair(kp + D, kv1, e);
          }
          __syncthreads();
          for (int kk = warp; kk < n; kk += kWarps) {
            float d = 0.f;
            for (int c = lane; c < hd; c += 32)
              d = fmaf(qs[c], ks[kk * hd + c], d);
            d = warp_sum(d) / sq;
            if (lane == 0) sc[kk] = d;
          }
          __syncthreads();
          float mc = m;
          for (int kk = 0; kk < n; ++kk) mc = fmaxf(mc, sc[kk]);
          const float corr = expf(m - mc);
          if (tid < n) pw[tid] = expf(sc[tid] - mc);
          __syncthreads();
          if (tid < hd) {
            float sa = 0.f, sl = 0.f;
            for (int kk = 0; kk < n; ++kk) {
              sa = fmaf(pw[kk], vs[kk * hd + tid], sa);
              sl += pw[kk];
            }
            acc = acc * corr + sa;
            l = l * corr + sl;
          }
          m = mc;
          __syncthreads();  // before the next chunk overwrites ks, vs, pw
        }
        u64* out = XL + p.x_parts + (h * nsplit + s) * (hd + 2);
        if (tid < hd) st_pair(out + 2 + tid, acc, e + 1);
        if (tid == 0) {
          st_pair(out, m, e + 1);
          st_pair(out + 1, l, e + 1);
        }
        stamp(a.stamps, st + 1, 0);
      }

      // ---- C: merge the partials (fixed order) -> att; out-proj ----
      {
        const int np = H * nsplit, ps = hd + 2;
        float* pb = work;  // (np, m l acc[hd])
        float* wgt = pb + np * ps;
        poll(XL + p.x_parts, pb, np * ps, e + 1);
        stamp(a.stamps, st + 1, 1);
        if (tid < np) {  // partial tid's weight against its head's max
          const float* ph = pb + (tid / nsplit) * nsplit * ps;
          float mx = -INFINITY;
          for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, ph[s * ps]);
          wgt[tid] = expf(pb[tid * ps] - mx);
        }
        __syncthreads();
        for (int c = tid; c < D; c += kThreads) {
          const int h = c / hd, d = c % hd;
          const float* ph = pb + h * nsplit * ps;
          const float* wh = wgt + h * nsplit;
          float acc = 0.f, lsum = 0.f;
          for (int s = 0; s < nsplit; ++s) {
            acc = fmaf(ph[s * ps + 2 + d], wh[s], acc);
            lsum = fmaf(ph[s * ps + 1], wh[s], lsum);
          }
          att[c] = acc / lsum;
        }
        __syncthreads();
        for (int s = warp; s * G + b < D; s += kWarps) {
          const int j = s * G + b;
          const float v = warp_dot(wl + p.o_wo + s * D, att, D / 4, lane) +
                          bl[p.cq + s];
          if (lane == 0) st_pair(XL + p.x_xc + j, xs[j] + v, e + 2);
        }
        stamp(a.stamps, st + 2, 0);
      }

      // ---- D: LayerNorm2 + FF0 + relu ----
      poll(XL + p.x_xc, xs, D, e + 2);
      stamp(a.stamps, st + 2, 1);
      layer_norm(xs, yn, ln + 2 * D, ln + 3 * D, D, lstat);
      for (int s = warp; s * G + b < F; s += kWarps) {
        const float v = warp_dot(wl + p.o_ff0 + s * D, yn, D / 4, lane) +
                        bl[p.cq + p.co + s];
        if (lane == 0) st_pair(XL + p.x_h + s * G + b, fmaxf(v, 0.f), e + 3);
      }
      stamp(a.stamps, st + 3, 0);

      // ---- E: FF1 + residual ----
      poll(XL + p.x_h, work, F, e + 3);
      stamp(a.stamps, st + 3, 1);
      for (int s = warp; s * G + b < D; s += kWarps) {
        const int j = s * G + b;
        const float v = warp_dot(wl + p.o_ff1 + s * F, work, F / 4, lane) +
                        bl[p.cq + p.co + p.c0 + s];
        if (lane == 0) st_pair(XL + p.x_xe + j, xs[j] + v, e + 4);
      }
      stamp(a.stamps, st + 4, 0);
    }

    // ---- logits and this block's first argmax ----
    // The publisher (warp 15, idle in the poll below) fences now: this
    // block's cache stores, made before the last barrier, are then ordered
    // before its argmax store, and the fence waits off the critical path.
    if (tid == kThreads - 32) fence_acq_rel();
    poll(X + (L - 1) * p.x_layer + p.x_xe, xs, D, e0 + 5 * L - 1);
    stamp(a.stamps, st0 + 5 * L - 1, 1);
    float bv = -INFINITY;
    int bi = a.BINS;
    for (int s = warp; s * G + b < a.BINS; s += kWarps)
      better(bv, bi, warp_dot(sm + p.o_pred + s * D, xs, D / 4, lane),
             s * G + b);
    block_argmax(bv, bi, wv, wi);
    if (tid == kThreads - 32) {
      const u64 hi = static_cast<u64>(e0 + 5 * L) << 32;
      const u64 v0 = hi | __float_as_uint(bv);
      const u64 v1 = hi | static_cast<unsigned>(bi);
      asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};" ::"l"(
                       X + p.x_arg + 2 * b),
                   "l"(v0), "l"(v1)
                   : "memory");
    }
    stamp(a.stamps, st0 + 5 * L, 0);
  }
  if (b == 0) {  // the last token's code
    const int t = T - 1;
    const int code = poll_argmax(
        a.xch + static_cast<size_t>(t & 1) * p.x_parity + p.x_arg,
        static_cast<unsigned>(t) * per_tok + 1 + 5 * L, a.BINS, wv, wi);
    stamp(a.stamps, t * per_tok + 5 * L, 1, true);
    if (tid == 0) a.codes[t] = code;
  }
}

}  // namespace

extern "C" int plm_decode_fwd(const float* tc, const float* pe,
                              const float* emb, const float* wqkv,
                              const float* bqkv, const float* wo,
                              const float* bo, const float* ln,
                              const float* ff0, const float* ff0b,
                              const float* ff1, const float* ff1b,
                              const float* pred, float* cache,
                              unsigned long long* xch, int* codes,
                              unsigned long long* stamps, int T, int L, int D,
                              int TC, int H, int F, int BINS, int go_id,
                              int grid, int smem_bytes, int xch_pairs,
                              void* stream) {
  if (T < 1 || L < 1 || H < 1 || D % 4 || F % 4 || D % H || D > kThreads || TC < 0 || TC >= D || H > kMaxParts || grid < H ||
      grid > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(D, F, L, BINS, H, grid);
  if (p.bytes != smem_bytes || p.x_total != xch_pairs)
    return static_cast<int>(cudaErrorInvalidValue);
  // the kernel's shared memory limit and co-residency, set up once per
  // device and size
  static int set_dev = -1, set_bytes = 0, per_sm = 0;
  int dev = 0, sms = 0, coop = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (grid > sms || smem_bytes > optin)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dev != set_dev || smem_bytes > set_bytes) {
    e = cudaFuncSetAttribute(plm_decode_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, plm_decode_kernel, kThreads, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    set_dev = dev;
    set_bytes = smem_bytes;
  }
  if (!coop || per_sm < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  Args a{tc,   pe,    emb, wqkv,   bqkv, wo, bo, ln, ff0, ff0b, ff1, ff1b,
         pred, cache, xch, codes, stamps, T, L, D, TC, H, F, BINS, go_id};
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(plm_decode_kernel), dim3(grid),
      dim3(kThreads), args, smem_bytes, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// n barriers of the earlier design in one cooperative launch of the decode
// kernel's grid (min(SMs, 132) blocks of 512 threads); iscratch: one zeroed
// int.
extern "C" int plm_barrier_probe(int* iscratch, int n, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = sms < kMaxGrid ? sms : kMaxGrid;
  unsigned int* bar = reinterpret_cast<unsigned int*>(iscratch);
  void* args[] = {&bar, &n};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(barrier_probe_kernel), dim3(grid),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
