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
// Several rows in one launch (plm_decode_rows_kernel<C>, C = kMaxRows = 4
// columns; a launch takes R <= C rows of one length T and runs one token
// loop for all of them). The products above fill one of the mma's eight B
// columns and copy it into the other seven; here row j sits in column j of
// every product's B fragment, so the weights are read once a token for all
// rows. Everything else runs once per row in the same chain (the same
// phases, handoffs and L2 hops; a handed-on vector and its byte count per
// row, the {value, epoch} pairs and argmax partials per row, one KV cache
// region per row). The rule it keeps: each row's codes equal that row's
// one-row launch bit for bit. So every sum runs in the one-row kernel's
// order within its column: the K split over warps and the fixed-order sum
// of its partials are functions of the tile count alone (matvec_cols),
// LayerNorm, the partials' merges and the argmax are the same expressions
// per row, and the attention takes each row's keys in the same four-key
// online-softmax steps (key k on warp k % 16, steps of 64 keys). That also
// needs the one-row launch's cluster size (the wrapper takes it from there)
// and its key chunk a multiple of 64 keys (128 at N = 16). Per-row work is
// spread over the threads where a row's share fits 128 of them (the
// products' outputs, the merges, the argmax), and LayerNorm's totals are
// taken once per row; the rows' attention runs one row after another
// through a ring of two 64-key stages (every row's chunks one stream, the
// first two issued at the token's start, each next one as the stage it
// lands in is freed), each row's warp states kept until one merge of all
// rows. The plan is computed on the host and passed with the arguments:
// computed in the kernel it held the loop's registers, and the kernel
// spilled.
// Shared memory at the shipped width (N = 16): the one-row layout is
// 226,112 bytes (x, xc, xl, qkv, h, the bf16 input and 16 partials a row,
// about 17.9 KB, and a 128-key stage, 36,864 bytes). Four such rows would
// not fit, so the multi-row layout keeps about 11.2 KB a row: x holds xc
// and the logits' input in place (each is written at the CTA's own rows
// while peers write theirs), h lands on the partials (their lives do not
// overlap), the warps' attention states share the split-K sums' space,
// and pred (35,840 bytes a CTA) is not resident: the last cluster copies
// it into the key stages (one bulk copy) after the attention, in time for
// the logits. Bytes at C = 1 / 2 / 3 / 4: 226,112 (the one-row layout) /
// 198,960 / 215,072 / 231,184 of 232,192; C = 5 needs 247,296.
// What the card showed (H100 SXM, 700 W): every row's codes equal its
// one-row launch at R = 2 / 3 / 4 and T = 1 / 37 / 120 / 500 / 800. A token
// of 4 rows takes 93 us at T = 500 and 100 us at T = 800 against 40 us for
// one row: 47 ms / 82 ms a launch against 20.6 / 33.8 ms a row, and 8 rows
// of 800 tokens 164 ms against 265 ms in 8 one-row launches. Per layer and
// token, 4 rows against one: A 3.3 / 1.5 us, B (the attention) 7.9 / 2.0,
// C 3.0 / 1.3, D 3.7 / 2.0, E 2.5 / 1.5; an L2 hop 2.8 / 1.6. B grows with
// the rows it takes one after another (about 0.8 us a 64-key chunk past the
// two issued at the token's start), the handoffs with their 4x stores.
// Tried and dropped: the plan computed in the kernel (it spilled 100-250
// bytes and every phase slowed, 103-121 us a token), two rows' four-key
// steps interleaved (spills), the attention's loads issued first (more
// registers, no gain), bulk copies for the chunks (cp.async.bulk) or for
// the handoffs (shared to peer shared): no gain.
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
constexpr int kMaxRows = 4;                // the multi-row kernel's columns
constexpr int kGroupKeys = 4 * kWarps;     // keys of a warp's four-key steps
constexpr int kRingSlots = 2;              // the multi-row kernel's key stages
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
// is in floats. C: the launch's columns (1: the one-row kernel; more: the
// multi-row kernel, whose per-row buffers repeat at strides sx, sq, sp, sv
// floats). kc = 0 when the layout does not fit.
struct Plan {
  int bq, bo, b0, b1, bp;       // rows a CTA owns at most: wqkv wo ff0 ff1 pred
  int rd, rf, hd, hdp, nsplit, ps, kc;
  int o_wo, o_ff0, o_ff1, o_pred;                          // bf16 elements
  int o_ln, o_bias, o_x, o_xc, o_xl, o_qkv, o_h, o_vb,    // floats
      o_parts, o_wst, o_red, o_stage;
  int sx, sq, sp, sv, so, o_out;  // multi-row: row strides, products' outputs
  int bytes;
  int x_parity, x_total;        // exchange pairs
};

__host__ __device__ inline Plan make_plan(int D, int F, int L, int BINS, int H,
                                          int N, int C) {
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
  p.sx = p.rd;
  p.sq = up4(3 * D);
  p.sp = imax(H * p.nsplit * p.ps, p.rf);
  p.sv = upn(imax(p.rd, p.rf), 16) / 2;
  p.so = up4(imax(p.bp, imax(p.bo, p.b1)));
  if (C == 1) {
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
    p.o_out = p.o_red;
    // one stage of kc keys, each key's k and v rows of hdp bf16 (hdp floats)
    const int avail = kSmemLimit - kStaticSmem - 4 * p.o_stage;
    p.kc = imin(kMaxKeyChunk, imax(0, avail) / (4 * p.hdp)) / kKeyChunkStep *
           kKeyChunkStep;
    p.bytes = 4 * p.o_stage + 4 * p.hdp * p.kc;
  } else {
    // pred passes through the key stage (the last cluster, after phase B)
    p.o_ln = p.o_pred / 2;
    p.o_bias = p.o_ln + 4 * D;
    p.o_x = p.o_bias + up4(p.bq + p.bo + p.b0 + p.b1);
    p.o_xc = p.o_xl = p.o_x;  // xc and the logits' input in place
    p.o_qkv = p.o_x + C * p.sx;
    p.o_parts = p.o_qkv + C * p.sq;
    p.o_h = p.o_parts;  // h after the partials' merge
    p.o_vb = p.o_parts + C * p.sp;
    p.o_out = p.o_vb + C * p.sv;
    p.o_red = p.o_out + C * p.so;
    p.o_wst = p.o_red;  // the warps' attention states, in phase B only
    p.o_stage = p.o_red + imax(kWarps * 16 * C, C * kWarps * p.ps);
    const int stage = imax(kRingSlots * kGroupKeys * p.hdp, p.bp * p.rd / 2);
    p.bytes = 4 * (p.o_stage + stage);
    const int blk = imax(imax(p.bq, p.b0), p.so);  // a column's outputs
    p.kc = p.bytes <= kSmemLimit - kStaticSmem && blk <= kThreads / C
               ? kGroupKeys
               : 0;
  }
  p.x_parity = ((L - 1) * D + 2 * N) * C;  // x of layers 0..L-2, argmax partials
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
  int R;                 // rows (the multi-row kernel; tc, cache, codes per row)
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

// A CTA's set-up: warp 0 bulk-copies CTA r's rows of layer c's matrices,
// np rows of pred (to o_pred) and the layer's LayerNorm weights into the
// CTA's shared memory, completing the mbarrier at mb; the block writes the
// biases of its rows [wqkv | wo | ff0 | ff1] to bias.
__device__ __forceinline__ void load_rows(const Args& a, const Plan& p, int c,
                                          int r, int np, float* sm,
                                          float* bias, uint32_t mb) {
  const int D = a.D, F = a.F, lane = threadIdx.x & 31;
  uint16_t* wsm = reinterpret_cast<uint16_t*>(sm);
  const int nq = owned(3 * D, p.bq, r), no = owned(D, p.bo, r);
  const int n0 = owned(F, p.b0, r), n1 = owned(D, p.b1, r);
  const int jq = r * p.bq, jo = r * p.bo, j0 = r * p.b0, j1 = r * p.b1,
            jp = r * p.bp;
  if (threadIdx.x < 32) {
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
  for (int s = threadIdx.x; s < p.bq + p.bo + p.b0 + p.b1; s += kThreads) {
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
  const Plan p = make_plan(D, F, L, a.BINS, H, N, 1);
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
  load_rows(a, p, c, r, np, sm, bias, mb);
  // the vector buffers zeroed (their padding past D or F is read by the
  // products)
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

// ---- the multi-row kernel (C columns, R <= C rows a launch) ----

// the multi-row kernel's mbarriers: the one-row kernel's, and pred's copy
// into the key stage (the last cluster)
constexpr int kMbPred = kNumMb, kNumMbRows = kNumMb + 1;

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// out[col * ostride + k] = dot(row k, column col of vb) for the R <= C
// columns of vb (column col at vb + col * vstride bf16, vb_pos order) and
// this CTA's cnt (<= kThreads / C) rows: matvec with lane group g of the
// mma's B fragment loading column g (zero for g >= R). The K split over the
// warps and the fixed-order sum of the splits' partials are matvec's, per
// column, so each column's sums are bit for bit a one-row launch's. red:
// kWarps x C x 16 floats. Ends with a block barrier.
template <int C>
__device__ __forceinline__ void matvec_cols(const uint16_t* w, int stride,
                                            int cnt, const uint16_t* vb,
                                            int vstride, int R, float* out,
                                            int ostride, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int tiles = (cnt + 15) >> 4;
  const int ls = imax(0, 4 - (tiles > 1 ? 32 - __clz(tiles - 1) : 0));
  const int splits = 1 << ls;
  const int ksteps = (stride + 15) >> 4, per = (ksteps + splits - 1) >> ls;
  if (warp < (tiles << ls)) {
    const int tile = warp >> ls, sp = warp & (splits - 1);
    const int lr = imin(tile * 16 + (lane & 15), cnt - 1);
    const uint32_t a_addr =
        smem_addr(w + static_cast<size_t>(lr) * stride + (lane >> 4) * 8);
    const bool has = g < R;
    const uint16_t* bp = vb + (has ? g : 0) * vstride + 4 * c4;
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
      uint2 b = has ? *reinterpret_cast<const uint2*>(bp + kb)
                    : make_uint2(0u, 0u);
      if (kb + 8 >= stride) a2 = a3 = b.y = 0u;  // past the row's end
      asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};"
          : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b.x), "r"(b.y));
    }
    // lane quad c4 holds columns 2 c4 (d0, d2) and 2 c4 + 1 (d1, d3), rows
    // g and g + 8
    float* rw = red + warp * C * 16;
    if (2 * c4 < C) {
      rw[32 * c4 + g] = d0;
      rw[32 * c4 + g + 8] = d2;
    }
    if (2 * c4 + 1 < C) {
      rw[32 * c4 + 16 + g] = d1;
      rw[32 * c4 + 24 + g] = d3;
    }
  }
  __syncthreads();
  constexpr int kColThreads = kThreads / C;
  const int col = threadIdx.x / kColThreads, k = threadIdx.x % kColThreads;
  if (col < R && k < cnt) {
    const int tile = k >> 4, r = k & 15;
    float sum = 0.f;
#pragma unroll
    for (int sp = 0; sp < kWarps; ++sp)  // unrolled: the loads issue together
      if (sp < splits) sum += red[(((tile << ls) + sp) * C + col) * 16 + r];
    out[col * ostride + k] = sum;
  }
  __syncthreads();
}

// vb[row * vstride + vb_pos(j)] = x[row * xstride + j] for j < n, rows < R
// (bf16 values already), by the block; ends with a block barrier
template <int C>
__device__ __forceinline__ void to_vb_rows(const float* x, int xstride, int n,
                                           int R, uint16_t* vb, int vstride) {
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int pos = vb_pos(j);
#pragma unroll
    for (int row = 0; row < C; ++row)
      if (row < R) vb[row * vstride + pos] = f2bf(x[row * xstride + j]);
  }
  __syncthreads();
}

// push_block for R rows: each row's own block (n <= 128 floats at offset
// off + row * stride, both multiples of 4) to every other CTA; starts with a
// block barrier
template <int C>
__device__ __forceinline__ void push_rows(const float* sm, int off, int stride,
                                          int n, int R, uint32_t mb, int N,
                                          int rank) {
  __syncthreads();
  // thread 16 u + p hands unit u (4 floats) of each row to CTA p (N <= 16)
  const int u = threadIdx.x >> 4, p = threadIdx.x & 15;
  if (u < n / 4 && p < N && p != rank) {
    const uint32_t pmb = peer_addr(mb, p);
    const float* src = sm + off + 4 * u;
    const uint32_t dst = peer_addr(smem_addr(src), p);  // offsets map as is
#pragma unroll
    for (int row = 0; row < C; ++row)
      if (row < R)
        push16(dst + 4 * row * stride,
               *reinterpret_cast<const float4*>(src + row * stride), pmb);
  }
}

// layer_norm for R rows (row i at xs + i * xstride, into vb + i * vstride):
// thread j holds x[j] of every row and each warp's sums are layer_norm's
// (the rows' shuffles interleave); thread i then totals row i's warp sums
// in layer_norm's fixed order, once, and hands every thread its mean and
// rstd. red: C x 2 kWarps + 2 C floats. Ends with a block barrier.
template <int C>
__device__ __forceinline__ void layer_norm_rows(const float* xs, int xstride,
                                                uint16_t* vb, int vstride,
                                                const float* w, const float* b,
                                                int D, float inv_d, int R,
                                                float* red) {
  const int j = threadIdx.x, warp = j >> 5, nw = cdiv(D, 32);
  float* stats = red + C * 2 * kWarps;  // mean, rstd of each row
  float x[C];
  if (warp < nw) {  // the warps past D issue nothing
    float s1[C], s2[C];
#pragma unroll
    for (int row = 0; row < C; ++row) {
      x[row] = row < R && j < D ? xs[row * xstride + j] - xs[row * xstride] : 0.f;
      s1[row] = x[row];
      s2[row] = x[row] * x[row];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int row = 0; row < C; ++row) {
        s1[row] += __shfl_xor_sync(kFull, s1[row], o);
        s2[row] += __shfl_xor_sync(kFull, s2[row], o);
      }
    }
    if ((j & 31) == 0) {
#pragma unroll
      for (int row = 0; row < C; ++row) {
        red[row * 2 * kWarps + 2 * warp] = s1[row];
        red[row * 2 * kWarps + 2 * warp + 1] = s2[row];
      }
    }
  }
  __syncthreads();
  if (j < R) {
    const float* rr = red + j * 2 * kWarps;
    float v[2 * kWarps];
#pragma unroll
    for (int k = 0; k < 2 * kWarps; ++k) v[k] = rr[k];  // the loads together
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      if (k < nw) {
        s1 += v[2 * k];
        s2 += v[2 * k + 1];
      }
    }
    const float mean = s1 * inv_d;
    stats[2 * j] = mean;
    stats[2 * j + 1] = rsqrtf(fmaxf(s2 * inv_d - mean * mean, 0.f) + 1e-5f);
  }
  __syncthreads();
  if (j < D) {
#pragma unroll
    for (int row = 0; row < C; ++row)
      if (row < R)
        vb[row * vstride + vb_pos(j)] =
            f2bf((x[row] - stats[2 * row]) * stats[2 * row + 1] * w[j] + b[j]);
  }
  __syncthreads();
}

// Each row's first argmax over the N argmax partials (2 pairs each, row i's
// at arg + 2 i N) of the last cluster's CTAs, once all carry epoch e, into
// code[i]: warp i polls row i's. Ends with a block barrier.
__device__ __forceinline__ void poll_argmax_rows(const u64* arg, unsigned e,
                                                 int N, int R, int BINS,
                                                 int* code) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < R) {
    float bv = -INFINITY;
    int bi = BINS;
    if (lane < N) {
      const u64* q = arg + 2 * (warp * N + lane);
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
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      better(bv, bi, __shfl_xor_sync(kFull, bv, o),
             __shfl_xor_sync(kFull, bi, o));
    if (lane == 0) code[warp] = bi < BINS ? bi : 0;
  }
  __syncthreads();
}

// The token loop of plm_decode_bf16_kernel for R <= C rows of one length
// (the header's "Several rows in one launch"): the same phases, handoffs and
// hops, each row's sums in the one-row kernel's order.
// its plan comes with the arguments (computed once on the host), so its
// fields are constant-bank operands and take no registers in the loop
template <int C>
__global__ void __launch_bounds__(kThreads, 1)
plm_decode_rows_kernel(const Args a, const Plan p, const int N) {
  extern __shared__ __align__(128) float sm[];
  __shared__ __align__(8) u64 mbar[kNumMbRows];
  __shared__ float wv[kWarps];
  __shared__ int wi[kWarps];
  __shared__ int prev[C];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = static_cast<int>(cluster_rank());
  const int c = static_cast<int>(cluster_index());  // the layer
  const int D = a.D, F = a.F, H = a.H, T = a.T, TC = a.TC, L = a.L, R = a.R;
  const int VQ = D - TC;
  const bool first = c == 0, last = c == L - 1;
  const int hd = p.hd, hdp = p.hdp, nsplit = p.nsplit, ps = p.ps;
  const int sx = p.sx, sq = p.sq, sp = p.sp, so = p.so;  // row strides, floats
  const int sv = 2 * p.sv;                                // bf16 elements
  const float rsq = 1.f / sqrtf(static_cast<float>(hd));
  const float inv_d = 1.f / D;
  const bool stamping = a.stamps != nullptr && r == 0 && tid == 0;
  // thread tid's row and index in a row's outputs of a product
  constexpr int kColThreads = kThreads / C;
  const int trow = tid / kColThreads, tk = tid % kColThreads;

  uint16_t* wsm = reinterpret_cast<uint16_t*>(sm);
  const float* lnw = sm + p.o_ln;
  float* bias = sm + p.o_bias;
  float* xs = sm + p.o_x;  // x, then xc, then (last layer) the logits' input
  float* qkv = sm + p.o_qkv;
  float* parts = sm + p.o_parts;  // the partials, then h
  uint16_t* vb = reinterpret_cast<uint16_t*>(sm + p.o_vb);
  float* out = sm + p.o_out;
  float* red = sm + p.o_red;
  float* wst = sm + p.o_wst;
  uint16_t* stage = reinterpret_cast<uint16_t*>(sm + p.o_stage);

  // this CTA's rows: [r * blk, r * blk + n*)
  const int nq = owned(3 * D, p.bq, r), no = owned(D, p.bo, r);
  const int n0 = owned(F, p.b0, r), n1 = owned(D, p.b1, r);
  const int np = last ? owned(a.BINS, p.bp, r) : 0;
  const int jq = r * p.bq, jo = r * p.bo, j0 = r * p.b0, j1 = r * p.b1,
            jp = r * p.bp;

  // ---- set-up: mbarriers, this CTA's rows (pred comes per token) ----
  const uint32_t mb = smem_addr(&mbar[0]);  // mbarrier k at mb + 8 k
  if (tid == 0) {
    for (int k = 0; k < kNumMbRows; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(mb + 8 * k)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid < C) prev[tid] = a.go_id;
  __syncthreads();
  load_rows(a, p, c, r, 0, sm, bias, mb);
  // the row buffers zeroed (the products read vb's padding past D or F)
  for (int i = p.o_x + tid; i < p.o_stage; i += kThreads) sm[i] = 0.f;
  const float* bq = bias;
  const float* bo = bq + p.bq;
  const float* b0 = bo + p.bo;
  const float* b1 = b0 + p.b0;
  cluster_sync();
  wait_phase(mb, 0);

  const bool attn = r < H * nsplit;
  const int ah = r % H, as = r / H;
  const int kc = p.kc, key_elems = 2 * hdp;
  // row i's cache at cache_s + i * row_cache
  const size_t row_cache =
      static_cast<size_t>(L) * H * nsplit * cdiv(T, nsplit) * key_elems;
  uint16_t* cache_s =
      a.cache + (static_cast<size_t>(c * H + ah) * nsplit + as) *
                    cdiv(T, nsplit) * key_elems;
  const int in_qkv = 4 * (3 * D - nq) * R, in_xc = 4 * (D - no) * R,
            in_h = 4 * (F - n0) * R, in_xl = 4 * (D - n1) * R,
            in_part = 4 * ps * (H * nsplit - (attn ? 1 : 0)) * R;
  const size_t arg_off = static_cast<size_t>(L - 1) * C * D;  // argmax pairs
  // thread tid's k / v element of this token's cache row (phase B)
  const int tkv = tid >= hd ? 1 : 0, tkd = tid - tkv * hd;

  int slot = 0, t_mod = 0;  // t = slot * nsplit + t_mod
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
    // every row's cached keys, one stream of kc-key chunks (row by row),
    // chunk q in stage q & 1; the first two issued now
    const int cached = attn ? slot + (t_mod > as ? 1 : 0) : 0;
    const int nchunk = cdiv(cached, kc), total = R * nchunk;
    int q_row = 0, q_ch = 0;  // the next chunk to issue
    auto issue = [&](int q) {
      const int n = imin(kc, cached - q_ch * kc);
      const uint16_t* src = cache_s + q_row * row_cache +
                            static_cast<size_t>(q_ch) * kc * key_elems;
      uint16_t* dst = stage + (q & 1) * kc * key_elems;
#pragma unroll 1
      for (int u = tid; u < n * key_elems / 8; u += kThreads)
        cp_async16(dst + 8 * u, src + 8 * u);
      cp_commit();
      if (++q_ch == nchunk) {
        q_ch = 0;
        ++q_row;
      }
    };
    if (total > 0) issue(0);
    if (total > 1) issue(1);

    // ---- x: built from the codes (layer 0) or polled from layer c - 1 ----
    if (first) {
      float xin[C];
#pragma unroll
      for (int row = 0; row < C; ++row) {
        xin[row] = 0.f;
        if (row < R && tid < D)
          xin[row] =
              (tid < TC ? __ldg(a.tc + (static_cast<size_t>(row) * T + t) * TC + tid)
                        : 0.f) +
              __ldg(a.pe + static_cast<size_t>(t) * D + tid);
      }
      if (t > 0) {
        poll_argmax_rows(a.xch + static_cast<size_t>((t - 1) & 1) * p.x_parity +
                             arg_off,
                         e0 - 1, N, R, a.BINS, prev);
        if (r == 0 && tid < R) a.codes[static_cast<size_t>(tid) * T + t - 1] = prev[tid];
      }
#pragma unroll
      for (int row = 0; row < C; ++row)
        if (row < R && tid < D)
          xs[row * sx + tid] =
              tid < TC ? xin[row]
                       : __ldg(a.emb + static_cast<size_t>(prev[row]) * VQ +
                               (tid - TC)) + xin[row];
      __syncthreads();
    } else {
      const u64* src = X + static_cast<size_t>(c - 1) * C * D + tid;
      const unsigned e = e0 + c - 1;
      if (tid < D) {
        u64 v[C];  // every row's pair loaded before any is waited on
#pragma unroll
        for (int row = 0; row < C; ++row) v[row] = ld_pair(src + row * D);
#pragma unroll
        for (int row = 0; row < C; ++row)
          if (row < R)
            xs[row * sx + tid] = epoch_of(v[row]) == e
                                     ? __uint_as_float(static_cast<unsigned>(v[row]))
                                     : spin_pair(src + row * D, e);
      }
      __syncthreads();
    }
    stamp(a.stamps, t, c, L, kReady, stamping);
    stamp(a.stamps, t, c, L, kWall, stamping);

    // ---- A: LayerNorm1 + QKV ----
    layer_norm_rows<C>(xs, sx, vb, sv, lnw, lnw + D, D, inv_d, R, red);
    stamp(a.stamps, t, c, L, kLn1, stamping);
    matvec_cols<C>(wsm, p.rd, nq, vb, sv, R, qkv + jq, sq, red);
    if (trow < R && tk < nq) qkv[trow * sq + jq + tk] += bq[tk];
    stamp(a.stamps, t, c, L, kQkvRows, stamping);
    push_rows<C>(sm, p.o_qkv + jq, sq, nq, R, mb + 8 * kMbQkv, N, r);
    stamp(a.stamps, t, c, L, kQkvOut, stamping);
    wait_phase(mb + 8 * kMbQkv, par);
    stamp(a.stamps, t, c, L, kQkvIn, stamping);

    // ---- B: each row's attention partial of (head ah, split as) ----
    // One row after another through the ring; at chunk q's barrier every
    // warp is done with chunk q - 1, whose stage takes chunk q + 1.
    if (attn) {
      const bool own_key = t_mod == as;
      for (int row = 0; row < R; ++row) {
        const float* qr = qkv + row * sq;
        float q[3], acc[3] = {0.f, 0.f, 0.f};
        float m = -INFINITY, l = 0.f;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int d = lane + 32 * j;
          q[j] = d < hd ? qr[ah * hd + d] : 0.f;
        }
        for (int ch = 0; ch < nchunk; ++ch) {
          const int qi = row * nchunk + ch;
          if (qi == 0 && total > 1)  // chunk 1, issued with it, may wait
            asm volatile("cp.async.wait_group 1;" ::: "memory");
          else
            cp_wait_all();
          __syncthreads();
          if (qi > 0 && qi + 1 < total) issue(qi + 1);
          const int n = imin(kc, cached - ch * kc);
          const uint16_t* st = stage + (qi & 1) * kc * key_elems;
          for (int kk = warp; kk < n; kk += 4 * kWarps)
            attend(st + kk * key_elems, kWarps * key_elems,
                   imin(4, (n - kk + kWarps - 1) / kWarps), q, hd, hdp, rsq,
                   lane, m, l, acc);
        }
        if (own_key && tid < 2 * hd)  // into the cache, for later tokens
          cache_s[row * row_cache + static_cast<size_t>(slot) * key_elems +
                  tkv * hdp + tkd] = f2bf(qr[(1 + tkv) * D + ah * hd + tkd]);
        if (own_key && warp == 0) {  // this token's key, float32
          float sa = 0.f;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const int d = lane + 32 * j;
            if (d < hd) sa = fmaf(q[j], qr[D + ah * hd + d], sa);
          }
          sa = warp_sum(sa) * rsq;
          const float mn = fmaxf(m, sa);
          const float corr = __expf(m - mn), pa = __expf(sa - mn);
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const int d = lane + 32 * j;
            if (d < hd)
              acc[j] = fmaf(pa, qr[2 * D + ah * hd + d], acc[j] * corr);
          }
          l = l * corr + pa;
          m = mn;
        }
        float* ws = wst + (row * kWarps + warp) * ps;
        if (lane == 0) {
          ws[0] = m;
          ws[1] = l;
        }
#pragma unroll
        for (int j = 0; j < 3; ++j)
          if (lane + 32 * j < hd) ws[2 + lane + 32 * j] = acc[j];
      }
      __syncthreads();
      // each row's partial, its warps merged in a fixed order (thread trow
      // * kColThreads + e: element e of row trow), into its own slot, then
      // handed on
      const int own = p.o_parts + (ah * nsplit + as) * ps;
      if (trow < R && tk < hd + 2) {
        const float* ws = wst + trow * kWarps * ps;
        float mx = -INFINITY;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ws[w * ps]);
        float sum = 0.f;
        if (tk == 0) {
          sum = mx;
        } else if (mx != -INFINITY) {
          float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int w = 0; w < kWarps; w += 4) {
#pragma unroll
            for (int k = 0; k < 4; ++k)
              s4[k] = fmaf(__expf(ws[(w + k) * ps] - mx), ws[(w + k) * ps + tk],
                           s4[k]);
          }
          sum = (s4[0] + s4[1]) + (s4[2] + s4[3]);
        }
        sm[own + trow * sp + tk] = sum;
      }
      push_rows<C>(sm, own, sp, ps, R, mb + 8 * kMbPart, N, r);
    }
    // pred's rows into the key stage, which no thread reads again this
    // token (the last read was before the barriers above)
    if (last && np > 0 && tid == 0) {
      fence_proxy_async();
      expect_bytes(mb + 8 * kMbPred, 2 * p.rd * np);
      bulk_copy(stage, a.pred + static_cast<size_t>(jp) * p.rd, 2 * p.rd * np,
                mb + 8 * kMbPred);
    }
    stamp(a.stamps, t, c, L, kPartOut, stamping);
    wait_phase(mb + 8 * kMbPart, par);
    stamp(a.stamps, t, c, L, kPartIn, stamping);

    // ---- C: merge the partials (fixed order) -> att; out-proj ----
    // thread trow * kColThreads + k: att[j] of row trow, j = k (mod
    // kColThreads)
    if (trow < R) {
      for (int j = tk; j < D; j += kColThreads) {
        const int th = j / hd, d = j - th * hd;
        const float* ph = parts + trow * sp + th * nsplit * ps;
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
        vb[trow * sv + vb_pos(j)] = f2bf(acc / lsum);
      }
    }
    __syncthreads();
    matvec_cols<C>(wsm + p.o_wo, p.rd, no, vb, sv, R, out, so, red);
    if (trow < R && tk < no) {
      float* x = xs + trow * sx + jo + tk;
      *x = out[trow * so + tk] + (*x + bo[tk]);  // xc, in place of x
    }
    push_rows<C>(sm, p.o_x + jo, sx, no, R, mb + 8 * kMbXc, N, r);
    stamp(a.stamps, t, c, L, kXcOut, stamping);
    wait_phase(mb + 8 * kMbXc, par);
    stamp(a.stamps, t, c, L, kXcIn, stamping);

    // ---- D: LayerNorm2 + FF0 + relu, h on the partials ----
    layer_norm_rows<C>(xs, sx, vb, sv, lnw + 2 * D, lnw + 3 * D, D, inv_d, R,
                       red);
    stamp(a.stamps, t, c, L, kLn2, stamping);
    matvec_cols<C>(wsm + p.o_ff0, p.rd, n0, vb, sv, R, parts + j0, sp, red);
    if (trow < R && tk < n0) {
      float* h = parts + trow * sp + j0 + tk;
      *h = round_bf(fmaxf(*h + b0[tk], 0.f));
    }
    stamp(a.stamps, t, c, L, kFf0Rows, stamping);
    push_rows<C>(sm, p.o_parts + j0, sp, n0, R, mb + 8 * kMbH, N, r);
    stamp(a.stamps, t, c, L, kHOut, stamping);
    wait_phase(mb + 8 * kMbH, par);
    stamp(a.stamps, t, c, L, kHIn, stamping);

    // ---- E: FF1 + residual: to the next layer's cluster, or the logits ----
    const unsigned ex = e0 + c;  // this cluster's hop epoch of token t
    to_vb_rows<C>(parts, sp, F, R, vb, sv);
    matvec_cols<C>(wsm + p.o_ff1, p.rf, n1, vb, sv, R, out, so, red);
    if (trow < R && tk < n1) {
      float* x = xs + trow * sx + j1 + tk;
      const float v = *x + out[trow * so + tk] + b1[tk];
      if (last)
        *x = round_bf(v);  // the logits' input, in place of xc
      else
        st_pair(X + (static_cast<size_t>(c) * C + trow) * D + j1 + tk, v, ex);
    }
    stamp(a.stamps, t, c, L, kEOut, stamping);
    if (last) {
      push_rows<C>(sm, p.o_x + j1, sx, n1, R, mb + 8 * kMbXl, N, r);
      wait_phase(mb + 8 * kMbXl, par);
      stamp(a.stamps, t, c, L, kXlIn, stamping);
      to_vb_rows<C>(xs, sx, D, R, vb, sv);
      if (np > 0) wait_phase(mb + 8 * kMbPred, par);
      matvec_cols<C>(stage, p.rd, np, vb, sv, R, out, so, red);
      // each row's first argmax over this CTA's logits: kColThreads threads
      // (kWarps / C warps) a row, then thread `row` merges its warps in order
      float bv = -INFINITY;
      int bi = a.BINS;
      if (trow < R && tk < np) better(bv, bi, out[trow * so + tk], jp + tk);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        better(bv, bi, __shfl_xor_sync(kFull, bv, o),
               __shfl_xor_sync(kFull, bi, o));
      if (lane == 0) {
        wv[warp] = bv;
        wi[warp] = bi;
      }
      __syncthreads();
      if (tid < R) {
        constexpr int kRowWarps = kWarps / C;
        bv = wv[tid * kRowWarps];
        bi = wi[tid * kRowWarps];
#pragma unroll
        for (int w = 1; w < kRowWarps; ++w)
          better(bv, bi, wv[tid * kRowWarps + w], wi[tid * kRowWarps + w]);
        const u64 hi = static_cast<u64>(ex) << 32;
        const u64 v0 = hi | __float_as_uint(bv);
        const u64 v1 = hi | static_cast<unsigned>(bi);
        asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};" ::"l"(
                         X + arg_off + 2 * (tid * N + r)),
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
  if (first && r == 0) {  // the last token's codes
    const int t = T - 1;
    poll_argmax_rows(a.xch + static_cast<size_t>(t & 1) * p.x_parity + arg_off,
                     static_cast<unsigned>(t) * L + L, N, R, a.BINS, prev);
    if (tid < R) a.codes[static_cast<size_t>(tid) * T + t] = prev[tid];
  }
  // no CTA leaves while a peer may still hand it anything
  cluster_sync();
}

// The kernel of a launch of `rows` rows: the one-row kernel, or the
// multi-row kernel at kMaxRows columns.
const void* kernel_of(int rows) {
  return rows == 1 ? reinterpret_cast<const void*>(plm_decode_bf16_kernel)
                   : reinterpret_cast<const void*>(
                         plm_decode_rows_kernel<kMaxRows>);
}

// Set-up of a kernel's attributes for this device and shared memory size.
int configure(int rows, int smem_bytes) {
  static int set_dev[2] = {-1, -1}, set_bytes[2] = {0, 0};
  const int k = rows > 1 ? 1 : 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev == set_dev[k] && smem_bytes <= set_bytes[k]) return 0;
  e = cudaFuncSetAttribute(kernel_of(rows),
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(kernel_of(rows),
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  set_dev[k] = dev;
  set_bytes[k] = smem_bytes;
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

// cudaOccupancyMaxActiveClusters of the kernel of a `rows`-row launch at
// cluster size N and smem_bytes of dynamic shared memory, into *max_active.
extern "C" int plm_decode_bf16_clusters(int N, int rows, int smem_bytes,
                                        int* max_active) {
  if (N < 1 || N > kMaxCluster || rows < 1 || rows > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = configure(rows, smem_bytes);
  if (err != 0) return err;
  cudaLaunchAttribute attrs[2];
  const cudaLaunchConfig_t cfg = launch_config(1, N, smem_bytes, attrs, false, 0);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(max_active, kernel_of(rows), &cfg));
}

// The matrices bf16 in rows of make_plan's rd / rf elements; `rows` (1 to
// kMaxRows) rows of T tokens: tc (rows, T, TC), the cache (rows, L, H,
// nsplit, cdiv(T, nsplit), 2, hdp) bf16, codes (rows, T); N the cluster
// size, one cluster per layer. One row runs plm_decode_bf16_kernel (plan
// C = 1), more the multi-row kernel (plan C = kMaxRows).
extern "C" int plm_decode_bf16_fwd(
    const float* tc, const float* pe, const float* emb, const void* wqkv,
    const float* bqkv, const void* wo, const float* bo, const float* ln,
    const void* ff0, const float* ff0b, const void* ff1, const float* ff1b,
    const void* pred, void* cache, unsigned long long* xch, int* codes,
    unsigned long long* stamps, int T, int L, int D, int TC, int H, int F,
    int BINS, int go_id, int N, int rows, int smem_bytes, int xch_pairs,
    void* stream) {
  if (T < 1 || L < 1 || H < 1 || D % 4 || F % 4 || D % H || D > kThreads ||
      D / H > kMaxHeadDim || TC < 0 || TC >= D || BINS < 1 ||
      N < kMinCluster || N > kMaxCluster || H > N || rows < 1 ||
      rows > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(D, F, L, BINS, H, N, rows == 1 ? 1 : kMaxRows);
  if (p.kc < kKeyChunkStep || p.bytes != smem_bytes || p.x_total != xch_pairs)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = configure(rows, smem_bytes);
  if (err != 0) return err;
  cudaLaunchAttribute attrs[2];
  int active = 0;
  cudaLaunchConfig_t cfg = launch_config(L, N, smem_bytes, attrs, false, 0);
  cudaError_t e =
      cudaOccupancyMaxActiveClusters(&active, kernel_of(rows), &cfg);
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
               go_id,
               rows};
  e = rows == 1
          ? cudaLaunchKernelEx(&cfg, plm_decode_bf16_kernel, a, N)
          : cudaLaunchKernelEx(&cfg, plm_decode_rows_kernel<kMaxRows>, a, p, N);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
