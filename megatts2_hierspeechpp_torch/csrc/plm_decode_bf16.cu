// Greedy KV-cached decode of the prosody LM (ProsodyLM), B = 1, with bf16
// matrices and a bf16 KV cache: the serving configuration of the TPU kernel
// megatts2_hierspeechpp_tpu/ops/pallas_plm_decode.py (_kernel, through
// plm_decode_greedy with weight_dtype = cache_dtype = bfloat16, its
// defaults). The whole token loop runs in one launch of L thread-block
// clusters, one cluster per layer. (float32 and the mixed configurations
// stay on plm_decode.cu.)
//
// What it computes, as plm_decode.cu's bf16 configuration and the plain twin
// (ops/plm_decode.py _plain_loop): per token t, x = [tc_t | emb(prev)] +
// pos_alpha * pe_t; per layer LayerNorm -> QKV -> causal attention over the
// cache -> out-proj -> residual -> LayerNorm -> FF(relu) -> residual; then
// logits and the first argmax, fed back as prev. The matrices wqkv, wo, ff0,
// ff1 and pred are bf16 (rows padded with zeros to 8 elements, 16 bytes);
// every product's vector is rounded to bf16 first (the LayerNorm outputs,
// att, h, and x before the logits); earlier tokens' k and v come from the
// bf16 cache, this token's stay float32; products, sums, biases, LayerNorm,
// embeddings, positions and the residual stream are float32.
//
// What bounds it on the H100: a token is a chain of 21 dependent
// matrix-vector phases over 7.9 MB of bf16 matrices (about 7.9 MFLOP), so
// the limit is the latency of the chain, not bytes or flops. plm_decode.cu
// spreads every matrix over 132 blocks and hands every phase's output on as
// {value, epoch} pairs in L2, polled by all 132 blocks: about 2.6 us a
// phase, 1.0-1.6 us of it waiting (its stamps on the card, bf16 as float32).
// A handoff inside a cluster through distributed shared memory (st.async
// completing the receiver's mbarrier) needs no L2 round trip and no polling
// by 132 blocks: this kernel's stamps put its wait at 0.2-0.5 us (the
// plm_bf16 line of chip_smoke.py).
//
// The design:
// * One cluster of N CTAs (N = 13-16, chosen by the wrapper from
//   cudaOccupancyMaxActiveClusters) per layer. In bf16 one layer's matrices
//   (1.85 MB) fit the cluster's shared memory (float32 would take 3.66 MB and
//   leave no room, so this design is bf16's own). CTA r owns a contiguous
//   block of each matrix's output rows, blk = up4(cdiv(rows, N)) rows from
//   r * blk, copied once per launch by bulk copies into an mbarrier.
// * pred (1024 x 280 bf16, 573 KB) sits on the last layer's cluster, beside
//   its layer: the logits then follow the last FF1 as one more in-cluster
//   handoff. A cluster of its own would add a fifth L2 hop to every token.
//   It is why N >= 13: at N = 12 the last cluster's share no longer fits.
// * Inside a cluster, a phase's output goes from its owner to every CTA by
//   st.async (16 bytes = 4 rows a store, from registers), each completing
//   the receiver's mbarrier with its byte count; the receiver expects the
//   phase's bytes once per token and waits on its own shared memory. One
//   mbarrier per handoff (qkv, attention partials, xc, h, and on the last
//   cluster the logits' input), each completing once per token, so parity t
//   & 1. Nothing inside a layer is polled from L2, and no cluster barrier
//   runs in the token loop (with release / acquire it costs more than the
//   handoff).
// * Between clusters (x from layer i to i + 1, and the code from the logits
//   back to layer 0) the handoff stays flag-carried: {float value, uint32
//   epoch} pairs in L2, written by the rows' owners and polled by every CTA
//   of the next cluster: 4 L2 hops a token, down from 21.
// * Attention: CTA r < H * nsplit (nsplit = N / H) takes head r % H and the
//   keys k = r / H (mod nsplit); each warp runs an online softmax over its
//   keys (four at a time), the CTA merges its warps and hands (m, l, acc) to
//   every CTA, which merges the splits in a fixed order.
// * The KV cache is the launch's own scratch, laid out (L, H, nsplit,
//   cdiv(T, nsplit), 2, hdp), key k of a split at slot k / nsplit, head rows
//   padded to hdp = up8(hd) = 72 elements: a CTA's keys are one contiguous
//   range, copied into shared memory in 16-byte units (cp.async.cg, L2 only)
//   in chunks of kc keys, the first issued at the start of the token,
//   before the wait for x, so its L2 round trip overlaps phase A. Key t's
//   k, v rows are written (rounded from the float32 qkv that every CTA holds
//   after phase A) by the one CTA that reads them at later tokens.
// * The products run on the tensor cores (mma.sync m16n8k16, the weights by
//   ldmatrix, the vector in all eight columns, see matvec), their vector a
//   bf16 copy in the order of the mma's B fragment.
//
// What the card showed (H100 SXM, T = 500): 20.6-21.3 ms against 29-30 ms
// for plm_decode.cu's bf16 configuration and 27-28 ms for its float32 one.
// A token takes about 40 us: 33 us inside the clusters, 6 us in the 4 L2
// hops. A handoff's wait is 0.2-0.5 us; the rest of each phase, 1.1-1.7 us,
// is its own work, bound by latency: dependent shared-memory loads (about
// 40 cycles each), block barriers, and four warps of a scheduler issuing the
// same code. SIMT dot products (1.5-2.1 us a phase), loops that left a
// shared-memory load's latency exposed at every step, and divisions by
// runtime values cost more than the handoffs did.
//
// Why it is right, hazard by hazard:
// * Bytes of a later token cannot count toward an earlier phase: a CTA hands
//   on phase X of token t + 1 only after the code of token t, which needs
//   every CTA of every cluster to have finished token t, and with it every
//   wait on X(t). A store that lands before its receiver's expect_tx only
//   drives the transaction count below 0; the phase still waits for the
//   receiver's own arrival.
// * Write after read: a buffer written at token t + 1 was last read at
//   token t, before its reader's part of the same chain.
// * The cache: a slot is written and later read by the same CTA, with block
//   barriers between, so it needs no ordering across CTAs.
// * Stale pairs: the wrapper zeroes the exchange buffer before every launch,
//   epochs start at 1, pairs alternate by token parity, and a wait that
//   lasts for seconds traps instead of hanging the card.
// * Co-residency: the clusters spin on each other, so all must be resident
//   at once. The launch asks for a cooperative launch together with the
//   cluster dimension, which the H100 accepts (CUDA 12.8, measured), so the
//   runtime refuses a grid that cannot be co-resident; the wrapper also
//   launches no more clusters than cudaOccupancyMaxActiveClusters allows.
// * No float atomics; every sum runs in a fixed order, so repeated launches
//   give the same codes.
//
// Stamps (optional): thread 0 of each cluster's rank-0 CTA records its SM
// clock at the points of kStampCols per (token, cluster), and %globaltimer
// once, for converting cycles to time (the columns below).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMinCluster = 10;
constexpr int kMaxCluster = 16;
constexpr int kMaxHeadDim = 96;   // a lane holds dims lane, lane + 32, lane + 64
constexpr int kMaxKeyChunk = 128;
constexpr int kKeyChunkStep = 16;
constexpr int kSmemLimit = 232448;
constexpr int kStaticSmem = 256;
constexpr int kStampCols = 17;
constexpr long long kSpinLimit = 1LL << 34;  // clock cycles, ~9 s
constexpr unsigned kFull = 0xffffffffu;
typedef unsigned long long u64;

// stamp columns (ops/plm_decode.py STAMP_COLUMNS): x in hand, then per
// handoff (qkv, partials, xc, h) when thread 0 has handed its part on and
// when its CTA holds the whole; E done; the logits' input in hand; the
// argmax published; %globaltimer at x in hand; LayerNorm1 done, the QKV
// rows done, LayerNorm2 done, the FF0 rows done
enum : int {
  kReady = 0, kQkvOut, kQkvIn, kPartOut, kPartIn, kXcOut, kXcIn, kHOut,
  kHIn, kEOut, kXlIn, kArgOut, kWall, kLn1, kQkvRows, kLn2, kFf0Rows
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int up4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int upn(int n, int m) { return (n + m - 1) / m * m; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// Layout of one CTA's dynamic shared memory and of the exchange buffer,
// computed the same way by ops/plm_decode.py (cluster_plan), which passes
// its byte and pair counts for a check. Matrices first, in bf16 elements
// (rows of rd = up8(D) or rf = up8(F) elements); every offset from o_ln on
// is in floats.
struct Plan {
  int bq, bo, b0, b1, bp;       // rows a CTA owns at most: wqkv wo ff0 ff1 pred
  int rd, rf, hd, hdp, nsplit, ps, kc;
  int o_wo, o_ff0, o_ff1, o_pred;                          // bf16 elements
  int o_ln, o_bias, o_x, o_xc, o_xl, o_qkv, o_h, o_vb,    // floats
      o_parts, o_wst, o_red, o_stage;
  int bytes;
  int x_parity, x_total;        // exchange pairs
};

__host__ __device__ inline Plan make_plan(int D, int F, int L, int BINS, int H,
                                          int N) {
  Plan p;
  p.bq = up4(cdiv(3 * D, N));
  p.bo = up4(cdiv(D, N));
  p.b0 = up4(cdiv(F, N));
  p.b1 = up4(cdiv(D, N));
  p.bp = up4(cdiv(BINS, N));
  p.rd = upn(D, 8);
  p.rf = upn(F, 8);
  p.hd = D / H;
  p.hdp = upn(p.hd, 8);
  p.nsplit = N / H;
  p.ps = up4(p.hd + 2);  // a partial: m, l, acc[hd]
  p.o_wo = p.bq * p.rd;
  p.o_ff0 = p.o_wo + p.bo * p.rd;
  p.o_ff1 = p.o_ff0 + p.b0 * p.rd;
  p.o_pred = p.o_ff1 + p.b1 * p.rf;
  p.o_ln = (p.o_pred + p.bp * p.rd) / 2;
  p.o_bias = p.o_ln + 4 * D;
  p.o_x = p.o_bias + up4(p.bq + p.bo + p.b0 + p.b1);
  p.o_xc = p.o_x + p.rd;
  p.o_xl = p.o_xc + p.rd;
  p.o_qkv = p.o_xl + p.rd;
  p.o_h = p.o_qkv + up4(3 * D);
  p.o_vb = p.o_h + p.rf;  // the products' input: bf16, in vb_pos order
  p.o_parts = p.o_vb + upn(imax(p.rd, p.rf), 16) / 2;
  p.o_wst = p.o_parts + H * p.nsplit * p.ps;
  p.o_red = p.o_wst + kWarps * p.ps;  // the products' split-K partials
  p.o_stage = p.o_red + kWarps * 16;
  // one stage of kc keys, each key's k and v rows of hdp bf16 (hdp floats)
  const int avail = kSmemLimit - kStaticSmem - 4 * p.o_stage;
  p.kc = imin(kMaxKeyChunk, imax(0, avail) / (4 * p.hdp)) / kKeyChunkStep *
         kKeyChunkStep;
  p.bytes = 4 * p.o_stage + 4 * p.hdp * p.kc;
  p.x_parity = (L - 1) * D + 2 * N;  // x of layers 0..L-2, argmax partials
  p.x_total = 2 * p.x_parity;
  return p;
}

// rows of a matrix of R rows that CTA r owns: [r * blk, r * blk + owned)
__host__ __device__ inline int owned(int R, int blk, int r) {
  return imax(0, imin(blk, R - r * blk));
}

struct Args {
  const float* tc;       // (T, TC)
  const float* pe;       // (T, D) pos_alpha * sine table
  const float* emb;      // (V, D - TC)
  const uint16_t* wqkv;  // (L, 3D, rd) bf16
  const float* bqkv;     // (L, 3D)
  const uint16_t* wo;    // (L, D, rd)
  const float* bo;       // (L, D)
  const float* ln;       // (L, 4, D): norm1 w, b, norm2 w, b
  const uint16_t* ff0;   // (L, F, rd)
  const float* ff0b;     // (L, F)
  const uint16_t* ff1;   // (L, D, rf)
  const float* ff1b;     // (L, D)
  const uint16_t* pred;  // (BINS, rd)
  uint16_t* cache;       // (L, H, nsplit, cdiv(T, nsplit), 2, hdp) bf16
  u64* xch;              // exchange pairs, zeroed (Plan::x_total)
  int* codes;            // (T,)
  u64* stamps;           // (T, L, kStampCols) or null
  int T, L, D, TC, H, F, BINS, go_id;
};

// ---- small helpers ----

__device__ __forceinline__ float bf2f(uint16_t b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}
// float32 -> bf16 bits, round to nearest even (as torch's .to(bfloat16))
__device__ __forceinline__ uint16_t f2bf(float f) {
  const unsigned u = __float_as_uint(f);
  return static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}
__device__ __forceinline__ float round_bf(float f) { return bf2f(f2bf(f)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum_pair(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFull, a, o);
    b += __shfl_xor_sync(kFull, b, o);
  }
  return a;
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
#pragma unroll
  for (int w = 1; w < kWarps; ++w) better(bv, bi, sv[w], si[w]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_index() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

// the shared::cluster address of local shared address a in CTA `rank`
__device__ __forceinline__ uint32_t peer_addr(uint32_t a, unsigned rank) {
  uint32_t o;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(o)
               : "r"(a), "r"(rank));
  return o;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// 16 bytes from registers into a peer's shared memory, completing 16 bytes
// of the transaction count of the peer's mbarrier at mb (both peer
// addresses)
__device__ __forceinline__ void push16(uint32_t dst, float4 v, uint32_t mb) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(mb)
      : "memory");
}

__device__ __forceinline__ void expect_bytes(uint32_t mb, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   mb),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `par` of the local mbarrier at mb has
// completed; traps after kSpinLimit cycles.
__device__ __forceinline__ void wait_phase(uint32_t mb, unsigned par) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{ .reg .pred P; mbarrier.try_wait.parity.shared::cta.b64 P, [%1], "
        "%2; selp.u32 %0, 1, 0, P; }"
        : "=r"(done)
        : "r"(mb), "r"(par)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kSpinLimit) __trap();
  }
}

// 1-D bulk async copy global -> shared, completion on the mbarrier at mb;
// both addresses 16-byte aligned, bytes a multiple of 16.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint32_t mb) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(mb)
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// ---- flag-carried pairs (between clusters) ----

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

// Spin until pair p carries epoch e; its value. Out of line: the code of the
// token loop is kept small for the instruction cache.
__device__ __noinline__ float spin_pair(const u64* p, unsigned e) {
  const long long t0 = clock64();
  u64 v;
  do {
    v = ld_pair(p);
    if (clock64() - t0 > kSpinLimit) __trap();
  } while (epoch_of(v) != e);
  return __uint_as_float(static_cast<unsigned>(v));
}

// dst[i] = the value of src[i] for i < n (n <= kThreads), each once it
// carries epoch e; ends with a block barrier.
__device__ __forceinline__ void poll(const u64* src, float* dst, int n,
                                     unsigned e) {
  if (threadIdx.x < n) {
    const u64 v = ld_pair(src + threadIdx.x);
    dst[threadIdx.x] = epoch_of(v) == e
                           ? __uint_as_float(static_cast<unsigned>(v))
                           : spin_pair(src + threadIdx.x, e);
  }
  __syncthreads();
}

// The first argmax over the N argmax partials (2 pairs each) of the last
// cluster's CTAs, once all carry epoch e; every thread gets the code.
__device__ __forceinline__ int poll_argmax(const u64* arg, unsigned e, int N,
                                           int BINS, float* sv, int* si) {
  float bv = -INFINITY;
  int bi = BINS;
  if (threadIdx.x < N) {
    const u64* q = arg + 2 * threadIdx.x;
    const long long t0 = clock64();
    u64 v0, v1;
    while (true) {
      v0 = ld_pair(q);
      v1 = ld_pair(q + 1);
      if (epoch_of(v0) == e && epoch_of(v1) == e) break;
      if (clock64() - t0 > kSpinLimit) __trap();
    }
    better(bv, bi, __uint_as_float(static_cast<unsigned>(v0)),
           static_cast<int>(static_cast<unsigned>(v1)));
  }
  block_argmax(bv, bi, sv, si);
  return bi < BINS ? bi : 0;
}

// ---- the matrix-vector products ----

// Position of input j in a product's bf16 input vector: each 16-input K
// step holds, for lane c of a quad, inputs 2c, 2c + 1, 2c + 8, 2c + 9 at
// 4c .. 4c + 3, so the mma's B fragment is one 8-byte load.
__device__ __forceinline__ int vb_pos(int j) {
  const int r = j & 15;
  return (j & ~15) | ((r & 6) << 1) | ((r >> 2) & 2) | (r & 1);
}

// out[k] = dot(row k, v) for this CTA's cnt (<= 16 kWarps) rows of a matrix
// block (row k at w + k * stride bf16 weights, stride a multiple of 8)
// against the bf16 vector vb (vb_pos order, zero or finite past the row's
// inputs), on the tensor cores: mma.sync m16n8k16, A a 16-row tile of the
// weights (ldmatrix), B the vector in all 8 columns. The warps split the
// tiles' K steps (tiles x splits <= kWarps, splits a power of two) and a
// fixed-order sum of the splits' partials (red: kWarps x 16 floats)
// finishes each row. Ends with a block barrier. (SIMT dot products took
// 1.5-2.1 us for 52-72 rows of 280: the bf16 unpacking doubles their
// instructions, and they stall on their own latency; this takes 0.8-0.9.)
__device__ __forceinline__ void matvec(const uint16_t* w, int stride, int cnt,
                                       const uint16_t* vb, float* out,
                                       float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int tiles = (cnt + 15) >> 4;
  const int ls = imax(0, 4 - (tiles > 1 ? 32 - __clz(tiles - 1) : 0));
  const int splits = 1 << ls;
  const int ksteps = (stride + 15) >> 4, per = (ksteps + splits - 1) >> ls;
  if (warp < (tiles << ls)) {
    const int tile = warp >> ls, sp = warp & (splits - 1);
    // ldmatrix.x4: lanes 0-15 address rows 0-15 at k 0-7, lanes 16-31 at
    // k 8-15, giving a0..a3 of the mma's A fragment
    const int lr = imin(tile * 16 + (lane & 15), cnt - 1);
    const uint32_t a_addr =
        smem_addr(w + static_cast<size_t>(lr) * stride + (lane >> 4) * 8);
    const uint16_t* bp = vb + 4 * c4;
    float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
    const int k1 = imin(ksteps, (sp + 1) * per);
#pragma unroll 2
    for (int ks = sp * per; ks < k1; ++ks) {
      const int kb = 16 * ks;
      uint32_t a0, a1, a2, a3;
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
          : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
          : "r"(a_addr + 2 * kb));
      uint2 b = *reinterpret_cast<const uint2*>(bp + kb);
      if (kb + 8 >= stride) a2 = a3 = b.y = 0u;  // past the row's end
      asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};"
          : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b.x), "r"(b.y));
    }
    if (c4 == 0) {  // every column holds the same sums: rows g and g + 8
      red[warp * 16 + g] = d0;
      red[warp * 16 + g + 8] = d2;
    }
  }
  __syncthreads();
  if (threadIdx.x < cnt) {
    const int tile = threadIdx.x >> 4, r = threadIdx.x & 15;
    float sum = 0.f;
#pragma unroll
    for (int sp = 0; sp < kWarps; ++sp)  // unrolled: the loads issue together
      if (sp < splits) sum += red[((tile << ls) + sp) * 16 + r];
    out[threadIdx.x] = sum;
  }
  __syncthreads();
}

// vb[vb_pos(j)] = x[j] for j < n (bf16 values already), by the block; ends
// with a block barrier
__device__ __forceinline__ void to_vb(const float* x, int n, uint16_t* vb) {
  for (int j = threadIdx.x; j < n; j += kThreads) vb[vb_pos(j)] = f2bf(x[j]);
  __syncthreads();
}

// Hand this CTA's own block of a vector (n <= 128 floats at local buffer
// offset `off`, a multiple of 4 floats) to every other CTA of the cluster,
// at the same offset, completing their mbarrier at local address mb.
// Starts with a block barrier (the block's rows were written by several
// warps).
__device__ __forceinline__ void push_block(const float* sm, int off, int n,
                                           uint32_t mb, int N, int rank) {
  __syncthreads();
  // thread 16 u + p hands unit u (4 floats) to CTA p (N <= 16)
  const int u = threadIdx.x >> 4, p = threadIdx.x & 15;
  if (u < n / 4 && p < N && p != rank)
    push16(peer_addr(smem_addr(sm + off + 4 * u), p),
           reinterpret_cast<const float4*>(sm + off)[u], peer_addr(mb, p));
}

// LayerNorm (eps 1e-5) of xs[0:D] into vb, rounded to bf16 (the product's
// input, vb_pos order), by the whole block, thread j holding x[j]: one pass
// of sums of x - x[0] and its square (the shift keeps the variance's
// difference small), each warp's, then their fixed-order total. red: 2
// kWarps floats. Ends with a block barrier.
__device__ __forceinline__ void layer_norm(const float* xs, uint16_t* vb,
                                           const float* w, const float* b,
                                           int D, float inv_d, float* red) {
  const int j = threadIdx.x, warp = j >> 5, nw = cdiv(D, 32);
  float x = 0.f;
  if (warp < nw) {  // the warps past D issue nothing
    x = j < D ? xs[j] - xs[0] : 0.f;
    float s1 = x, s2 = x * x;
    warp_sum_pair(s1, s2);
    if ((j & 31) == 0) {
      red[2 * warp] = s1;
      red[2 * warp + 1] = s2;
    }
  }
  __syncthreads();
  if (j < D) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {  // unrolled: the loads issue together
      if (k < nw) {
        s1 += red[2 * k];
        s2 += red[2 * k + 1];
      }
    }
    const float mean = s1 * inv_d;
    const float rstd = rsqrtf(fmaxf(s2 * inv_d - mean * mean, 0.f) + 1e-5f);
    vb[vb_pos(j)] = f2bf((x - mean) * rstd * w[j] + b[j]);
  }
  __syncthreads();
}

// One online-softmax step of a warp over the nk (1-4) keys kp, kp + step,
// ... (rows of hdp bf16: k then v); q, acc: this lane's dims lane + 32 j.
// Four keys at a time: their sums' shuffles interleave.
__device__ __forceinline__ void attend(const uint16_t* kp, int step, int nk,
                                      const float (&q)[3], int hd, int hdp,
                                      float rsq, int lane, float& m, float& l,
                                      float (&acc)[3]) {
  float sc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint16_t* kr = kp + (k < nk ? k : 0) * step;
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) v = fmaf(q[j], bf2f(kr[d]), v);
    }
    sc[k] = v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) sc[k] += __shfl_xor_sync(kFull, sc[k], o);
  }
  float mn = m;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    sc[k] = k < nk ? sc[k] * rsq : -INFINITY;
    mn = fmaxf(mn, sc[k]);
  }
  const float corr = __expf(m - mn);
  l *= corr;
#pragma unroll
  for (int j = 0; j < 3; ++j) acc[j] *= corr;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float pk = __expf(sc[k] - mn);
    const uint16_t* vr = kp + (k < nk ? k : 0) * step + hdp;
    l += pk;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) acc[j] = fmaf(pk, bf2f(vr[d]), acc[j]);
    }
  }
  m = mn;
}

__device__ __forceinline__ void stamp(u64* stamps, int t, int c, int L,
                                      int col, bool on) {
  if (on) {
    u64 v;  // "memory": not moved across the waits around it
    if (col == kWall)
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v)::"memory");
    else
      asm volatile("mov.u64 %0, %%clock64;" : "=l"(v)::"memory");
    stamps[(static_cast<size_t>(t) * L + c) * kStampCols + col] = v;
  }
}

enum : int { kMbW = 0, kMbQkv, kMbPart, kMbXc, kMbH, kMbXl, kNumMb };

__global__ void __launch_bounds__(kThreads, 1)
plm_decode_bf16_kernel(const Args a, const int N) {
  extern __shared__ __align__(128) float sm[];
  __shared__ __align__(8) u64 mbar[kNumMb];
  __shared__ float wv[kWarps];
  __shared__ int wi[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = static_cast<int>(cluster_rank());
  const int c = static_cast<int>(cluster_index());  // the layer
  const int D = a.D, F = a.F, H = a.H, T = a.T, TC = a.TC, L = a.L;
  const int VQ = D - TC;
  const bool first = c == 0, last = c == L - 1;
  const Plan p = make_plan(D, F, L, a.BINS, H, N);
  const int hd = p.hd, hdp = p.hdp, nsplit = p.nsplit, ps = p.ps;
  const float rsq = 1.f / sqrtf(static_cast<float>(hd));
  const float inv_d = 1.f / D;
  const bool stamping = a.stamps != nullptr && r == 0 && tid == 0;

  uint16_t* wsm = reinterpret_cast<uint16_t*>(sm);
  const float* lnw = sm + p.o_ln;
  float* bias = sm + p.o_bias;
  float* xs = sm + p.o_x;
  float* xc = sm + p.o_xc;
  float* xl = sm + p.o_xl;
  uint16_t* vb = reinterpret_cast<uint16_t*>(sm + p.o_vb);
  float* qkv = sm + p.o_qkv;
  float* hb = sm + p.o_h;
  float* parts = sm + p.o_parts;
  float* wst = sm + p.o_wst;
  float* red = sm + p.o_red;
  uint16_t* stage = reinterpret_cast<uint16_t*>(sm + p.o_stage);

  // this CTA's rows: [r * blk, r * blk + n*)
  const int nq = owned(3 * D, p.bq, r), no = owned(D, p.bo, r);
  const int n0 = owned(F, p.b0, r), n1 = owned(D, p.b1, r);
  const int np = last ? owned(a.BINS, p.bp, r) : 0;
  const int jq = r * p.bq, jo = r * p.bo, j0 = r * p.b0, j1 = r * p.b1,
            jp = r * p.bp;

  // ---- set-up: mbarriers, this CTA's rows and LayerNorm weights ----
  const uint32_t mb = smem_addr(&mbar[0]);  // mbarrier k at mb + 8 k
  if (tid == 0) {
    for (int k = 0; k < kNumMb; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(mb + 8 * k)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    const int row_d = 2 * p.rd, row_f = 2 * p.rf;
    if (lane == 0)
      expect_bytes(mb, row_d * (nq + no + n0 + np) + row_f * n1 + 16 * D);
    __syncwarp();
    int k = 0;  // copies dealt round-robin over the lanes
    auto copy = [&](void* dst, const void* src, int bytes) {
      if ((k++ & 31) == lane) bulk_copy(dst, src, bytes, mb);
    };
    const size_t l3 = static_cast<size_t>(c) * 3 * D, l1 = static_cast<size_t>(c) * D,
                 lf = static_cast<size_t>(c) * F;
    for (int s = 0; s < nq; ++s)
      copy(wsm + s * p.rd, a.wqkv + (l3 + jq + s) * p.rd, row_d);
    for (int s = 0; s < no; ++s)
      copy(wsm + p.o_wo + s * p.rd, a.wo + (l1 + jo + s) * p.rd, row_d);
    for (int s = 0; s < n0; ++s)
      copy(wsm + p.o_ff0 + s * p.rd, a.ff0 + (lf + j0 + s) * p.rd, row_d);
    for (int s = 0; s < n1; ++s)
      copy(wsm + p.o_ff1 + s * p.rf, a.ff1 + (l1 + j1 + s) * p.rf, row_f);
    for (int s = 0; s < np; ++s)
      copy(wsm + p.o_pred + s * p.rd,
           a.pred + static_cast<size_t>(jp + s) * p.rd, row_d);
    copy(sm + p.o_ln, a.ln + static_cast<size_t>(c) * 4 * D, 16 * D);
  }
  // biases of the owned rows [wqkv | wo | ff0 | ff1]; the vector buffers
  // zeroed (their padding past D or F is read by the products)
  for (int s = tid; s < p.bq + p.bo + p.b0 + p.b1; s += kThreads) {
    float v = 0.f;
    int k = s;
    if (k < p.bq) {
      if (k < nq) v = a.bqkv[c * 3 * D + jq + k];
    } else if ((k -= p.bq) < p.bo) {
      if (k < no) v = a.bo[c * D + jo + k];
    } else if ((k -= p.bo) < p.b0) {
      if (k < n0) v = a.ff0b[c * F + j0 + k];
    } else if ((k -= p.b0) < n1) {
      v = a.ff1b[c * D + j1 + k];
    }
    bias[s] = v;
  }
  for (int i = p.o_x + tid; i < p.o_parts; i += kThreads) sm[i] = 0.f;
  const float* bq = bias;
  const float* bo = bq + p.bq;
  const float* b0 = bo + p.bo;
  const float* b1 = b0 + p.b0;
  // every CTA's mbarriers initialised before any peer hands it anything
  cluster_sync();
  wait_phase(mb, 0);

  // attention: head ah, keys k = as (mod nsplit) (CTAs r >= H * nsplit
  // take none); their k, v rows in this CTA's part of the cache, key k at
  // slot k / nsplit
  const bool attn = r < H * nsplit;
  const int ah = r % H, as = r / H;
  const int kc = p.kc, key_elems = 2 * hdp;
  uint16_t* cache_s =
      a.cache + (static_cast<size_t>(c * H + ah) * nsplit + as) *
                    cdiv(T, nsplit) * key_elems;
  // the own slot of each handed-on vector, and the bytes that come in
  const int in_qkv = 4 * (3 * D - nq), in_xc = 4 * (D - no),
            in_h = 4 * (F - n0), in_xl = 4 * (D - n1),
            in_part = 4 * ps * (H * nsplit - (attn ? 1 : 0));

  // thread tid's head and dim of att (phase C), and its k / v element of
  // this token's cache row (phase B)
  const int th = tid / hd, td = tid - th * hd;
  const int tkv = tid >= hd ? 1 : 0, tkd = tid - tkv * hd;
  int slot = 0, t_mod = 0;  // t = slot * nsplit + t_mod
  int prev = a.go_id;
  for (int t = 0; t < T; ++t) {
    const unsigned par = static_cast<unsigned>(t & 1);
    u64* X = a.xch + static_cast<size_t>(t & 1) * p.x_parity;
    const unsigned e0 = static_cast<unsigned>(t) * L + 1;
    if (tid == 0) {
      expect_bytes(mb + 8 * kMbQkv, in_qkv);
      expect_bytes(mb + 8 * kMbPart, in_part);
      expect_bytes(mb + 8 * kMbXc, in_xc);
      expect_bytes(mb + 8 * kMbH, in_h);
      if (last) expect_bytes(mb + 8 * kMbXl, in_xl);
    }
    // this CTA's cached keys (those before t): slots [0, cached), staged kc
    // at a time, the first chunk issued now
    const int cached = attn ? slot + (t_mod > as ? 1 : 0) : 0;
    const int nchunk = cdiv(cached, kc);
    auto issue = [&](int ch) {
      const int n = imin(kc, cached - ch * kc);
      const uint16_t* src = cache_s + static_cast<size_t>(ch) * kc * key_elems;
#pragma unroll 1
      for (int u = tid; u < n * key_elems / 8; u += kThreads)
        cp_async16(stage + 8 * u, src + 8 * u);
      cp_commit();
    };
    if (nchunk > 0) issue(0);

    // ---- x: built from the code (layer 0) or polled from layer c - 1 ----
    if (first) {
      float xin = 0.f;
      if (tid < D)
        xin = (tid < TC ? __ldg(a.tc + static_cast<size_t>(t) * TC + tid) : 0.f) +
              __ldg(a.pe + static_cast<size_t>(t) * D + tid);
      if (t > 0) {
        prev = poll_argmax(a.xch + static_cast<size_t>((t - 1) & 1) * p.x_parity +
                               (L - 1) * D,
                           e0 - 1, N, a.BINS, wv, wi);
        if (r == 0 && tid == 0) a.codes[t - 1] = prev;
      }
      if (tid < D)
        xs[tid] = tid < TC ? xin
                           : __ldg(a.emb + static_cast<size_t>(prev) * VQ +
                                   (tid - TC)) + xin;
      __syncthreads();
    } else {
      poll(X + (c - 1) * D, xs, D, e0 + c - 1);
    }
    stamp(a.stamps, t, c, L, kReady, stamping);
    stamp(a.stamps, t, c, L, kWall, stamping);

    // ---- A: LayerNorm1 + QKV ----
    layer_norm(xs, vb, lnw, lnw + D, D, inv_d, red);
    stamp(a.stamps, t, c, L, kLn1, stamping);
    matvec(wsm, p.rd, nq, vb, qkv + jq, red);
    if (tid < nq) qkv[jq + tid] += bq[tid];
    stamp(a.stamps, t, c, L, kQkvRows, stamping);
    push_block(sm, p.o_qkv + jq, nq, mb + 8 * kMbQkv, N, r);
    stamp(a.stamps, t, c, L, kQkvOut, stamping);
    wait_phase(mb + 8 * kMbQkv, par);
    stamp(a.stamps, t, c, L, kQkvIn, stamping);

    // ---- B: attention partial of (head ah, split as) ----
    if (attn) {
      float q[3], acc[3] = {0.f, 0.f, 0.f};
      float m = -INFINITY, l = 0.f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int d = lane + 32 * j;
        q[j] = d < hd ? qkv[ah * hd + d] : 0.f;
      }
      for (int ch = 0; ch < nchunk; ++ch) {
        cp_wait_all();
        __syncthreads();
        const int n = imin(kc, cached - ch * kc);
        for (int kk = warp; kk < n; kk += 4 * kWarps)
          attend(stage + kk * key_elems, kWarps * key_elems,
                 imin(4, (n - kk + kWarps - 1) / kWarps), q, hd, hdp, rsq,
                 lane, m, l, acc);
        __syncthreads();
        if (ch + 1 < nchunk) issue(ch + 1);
      }
      const bool own_key = t_mod == as;
      if (own_key && tid < 2 * hd)  // into the cache, for later tokens
        cache_s[static_cast<size_t>(slot) * key_elems + tkv * hdp + tkd] =
            f2bf(qkv[(1 + tkv) * D + ah * hd + tkd]);
      if (own_key && warp == 0) {  // this token's key, float32
        float sa = 0.f;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int d = lane + 32 * j;
          if (d < hd) sa = fmaf(q[j], qkv[D + ah * hd + d], sa);
        }
        sa = warp_sum(sa) * rsq;
        const float mn = fmaxf(m, sa);
        const float corr = __expf(m - mn), pa = __expf(sa - mn);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int d = lane + 32 * j;
          if (d < hd)
            acc[j] = fmaf(pa, qkv[2 * D + ah * hd + d], acc[j] * corr);
        }
        l = l * corr + pa;
        m = mn;
      }
      float* ws = wst + warp * ps;
      if (lane == 0) {
        ws[0] = m;
        ws[1] = l;
      }
#pragma unroll
      for (int j = 0; j < 3; ++j)
        if (lane + 32 * j < hd) ws[2 + lane + 32 * j] = acc[j];
      __syncthreads();
      // the CTA's partial, its warps merged in a fixed order, into its own
      // slot, then handed on
      const int own = p.o_parts + (ah * nsplit + as) * ps;
      if (tid < hd + 2) {
        float mx = -INFINITY;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wst[w * ps]);
        float sum = 0.f;
        if (tid == 0) {
          sum = mx;
        } else if (mx != -INFINITY) {
          float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int w = 0; w < kWarps; w += 4) {
#pragma unroll
            for (int k = 0; k < 4; ++k)
              s4[k] = fmaf(__expf(wst[(w + k) * ps] - mx),
                           wst[(w + k) * ps + tid], s4[k]);
          }
          sum = (s4[0] + s4[1]) + (s4[2] + s4[3]);
        }
        sm[own + tid] = sum;
      }
      __syncthreads();
      for (int idx = tid; idx < (ps / 4) * 16; idx += kThreads) {
        const int u = idx >> 4, pr = idx & 15;
        if (pr < N && pr != r)
          push16(peer_addr(smem_addr(sm + own + 4 * u), pr),
                 reinterpret_cast<const float4*>(sm + own)[u],
                 peer_addr(mb + 8 * kMbPart, pr));
      }
    }
    stamp(a.stamps, t, c, L, kPartOut, stamping);
    wait_phase(mb + 8 * kMbPart, par);
    stamp(a.stamps, t, c, L, kPartIn, stamping);

    // ---- C: merge the partials (fixed order) -> att; out-proj ----
    if (tid < D) {
      const int d = td;
      const float* ph = parts + th * nsplit * ps;
      float mx = -INFINITY;
#pragma unroll 4
      for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, ph[s * ps]);
      float acc = 0.f, lsum = 0.f;
#pragma unroll 4
      for (int s = 0; s < nsplit; ++s) {
        const float wgt = __expf(ph[s * ps] - mx);
        acc = fmaf(ph[s * ps + 2 + d], wgt, acc);
        lsum = fmaf(ph[s * ps + 1], wgt, lsum);
      }
      vb[vb_pos(tid)] = f2bf(acc / lsum);
    }
    __syncthreads();
    matvec(wsm + p.o_wo, p.rd, no, vb, xc + jo, red);
    if (tid < no) xc[jo + tid] += xs[jo + tid] + bo[tid];
    push_block(sm, p.o_xc + jo, no, mb + 8 * kMbXc, N, r);
    stamp(a.stamps, t, c, L, kXcOut, stamping);
    wait_phase(mb + 8 * kMbXc, par);
    stamp(a.stamps, t, c, L, kXcIn, stamping);

    // ---- D: LayerNorm2 + FF0 + relu ----
    layer_norm(xc, vb, lnw + 2 * D, lnw + 3 * D, D, inv_d, red);
    stamp(a.stamps, t, c, L, kLn2, stamping);
    matvec(wsm + p.o_ff0, p.rd, n0, vb, hb + j0, red);
    if (tid < n0) hb[j0 + tid] = round_bf(fmaxf(hb[j0 + tid] + b0[tid], 0.f));
    stamp(a.stamps, t, c, L, kFf0Rows, stamping);
    push_block(sm, p.o_h + j0, n0, mb + 8 * kMbH, N, r);
    stamp(a.stamps, t, c, L, kHOut, stamping);
    wait_phase(mb + 8 * kMbH, par);
    stamp(a.stamps, t, c, L, kHIn, stamping);

    // ---- E: FF1 + residual: to the next layer's cluster, or the logits ----
    const unsigned ex = e0 + c;  // this cluster's hop epoch of token t
    to_vb(hb, F, vb);
    matvec(wsm + p.o_ff1, p.rf, n1, vb, wst, red);
    if (tid < n1) {
      const float v = xc[j1 + tid] + wst[tid] + b1[tid];
      if (last)
        xl[j1 + tid] = round_bf(v);
      else
        st_pair(X + c * D + j1 + tid, v, ex);
    }
    stamp(a.stamps, t, c, L, kEOut, stamping);
    if (last) {
      push_block(sm, p.o_xl + j1, n1, mb + 8 * kMbXl, N, r);
      wait_phase(mb + 8 * kMbXl, par);
      stamp(a.stamps, t, c, L, kXlIn, stamping);
      float bv = -INFINITY;
      int bi = a.BINS;
      to_vb(xl, D, vb);
      matvec(wsm + p.o_pred, p.rd, np, vb, wst, red);
      if (tid < np) better(bv, bi, wst[tid], jp + tid);
      block_argmax(bv, bi, wv, wi);
      if (tid == 0) {
        const u64 hi = static_cast<u64>(ex) << 32;
        const u64 v0 = hi | __float_as_uint(bv);
        const u64 v1 = hi | static_cast<unsigned>(bi);
        asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};" ::"l"(
                         X + (L - 1) * D + 2 * r),
                     "l"(v0), "l"(v1)
                     : "memory");
      }
      stamp(a.stamps, t, c, L, kArgOut, stamping);
    }
    if (++t_mod == nsplit) {
      t_mod = 0;
      ++slot;
    }
  }
  if (first && r == 0) {  // the last token's code
    const int t = T - 1;
    const int code = poll_argmax(
        a.xch + static_cast<size_t>(t & 1) * p.x_parity + (L - 1) * D,
        static_cast<unsigned>(t) * L + L, N, a.BINS, wv, wi);
    if (tid == 0) a.codes[t] = code;
  }
  // no CTA leaves while a peer may still hand it anything
  cluster_sync();
}

// Set-up of the kernel's attributes for this device and shared memory size.
int configure(int smem_bytes) {
  static int set_dev = -1, set_bytes = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev == set_dev && smem_bytes <= set_bytes) return 0;
  e = cudaFuncSetAttribute(plm_decode_bf16_kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(plm_decode_bf16_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  set_dev = dev;
  set_bytes = smem_bytes;
  return 0;
}

cudaLaunchConfig_t launch_config(int L, int N, int smem_bytes,
                                 cudaLaunchAttribute* attrs, bool coop,
                                 cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L * N);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = N;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = coop ? 2 : 1;
  return cfg;
}

}  // namespace

// cudaOccupancyMaxActiveClusters of the kernel at cluster size N and
// smem_bytes of dynamic shared memory, into *max_active.
extern "C" int plm_decode_bf16_clusters(int N, int smem_bytes,
                                        int* max_active) {
  if (N < 1 || N > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  int err = configure(smem_bytes);
  if (err != 0) return err;
  cudaLaunchAttribute attrs[2];
  const cudaLaunchConfig_t cfg = launch_config(1, N, smem_bytes, attrs, false, 0);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      max_active, reinterpret_cast<const void*>(plm_decode_bf16_kernel), &cfg));
}

// The matrices bf16 in rows of make_plan's rd / rf elements; the cache (L,
// H, T, 2, hdp) bf16; N the cluster size, one cluster per layer.
extern "C" int plm_decode_bf16_fwd(
    const float* tc, const float* pe, const float* emb, const void* wqkv,
    const float* bqkv, const void* wo, const float* bo, const float* ln,
    const void* ff0, const float* ff0b, const void* ff1, const float* ff1b,
    const void* pred, void* cache, unsigned long long* xch, int* codes,
    unsigned long long* stamps, int T, int L, int D, int TC, int H, int F,
    int BINS, int go_id, int N, int smem_bytes, int xch_pairs, void* stream) {
  if (T < 1 || L < 1 || H < 1 || D % 4 || F % 4 || D % H || D > kThreads ||
      D / H > kMaxHeadDim || TC < 0 || TC >= D || BINS < 1 ||
      N < kMinCluster || N > kMaxCluster || H > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(D, F, L, BINS, H, N);
  if (p.kc < kKeyChunkStep || p.bytes != smem_bytes || p.x_total != xch_pairs)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = configure(smem_bytes);
  if (err != 0) return err;
  cudaLaunchAttribute attrs[2];
  int active = 0;
  cudaLaunchConfig_t cfg = launch_config(L, N, smem_bytes, attrs, false, 0);
  cudaError_t e = cudaOccupancyMaxActiveClusters(
      &active, reinterpret_cast<const void*>(plm_decode_bf16_kernel), &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (active < L) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  cfg = launch_config(L, N, smem_bytes, attrs, true,
                      static_cast<cudaStream_t>(stream));
  const Args a{tc,
               pe,
               emb,
               static_cast<const uint16_t*>(wqkv),
               bqkv,
               static_cast<const uint16_t*>(wo),
               bo,
               ln,
               static_cast<const uint16_t*>(ff0),
               ff0b,
               static_cast<const uint16_t*>(ff1),
               ff1b,
               static_cast<const uint16_t*>(pred),
               static_cast<uint16_t*>(cache),
               xch,
               codes,
               stamps,
               T,
               L,
               D,
               TC,
               H,
               F,
               BINS,
               go_id};
  e = cudaLaunchKernelEx(&cfg, plm_decode_bf16_kernel, a, N);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
