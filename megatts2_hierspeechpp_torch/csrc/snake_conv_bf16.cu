// The bf16 configuration of the anti-aliased SnakeBeta -> dilated 1-D conv
// (+ bias, + optional residual) on (B, T, C), for Hopper (sm_90a):
//
//   y = conv_d(AAsnake(x)) + b (+ res)
//
// with the conv's operands rounded to bf16 (round to nearest even) and their
// products summed in float32; the snake, its 12 resampler taps, the bias and
// the residual stay float32. x, res and y are each float32 or bf16 per
// launch (kXBf16 / kResBf16 / kYBf16), as ops/ampblock.py:run_block and
// ops/amp_triple.py use them: a block's first launch reads bf16 x, its
// second adds it as the residual, the intermediates between launches are
// float32, the block's last launch writes bf16.
//
// Replaces the per-layer work of the TPU kernels' bf16 configuration:
// megatts2_hierspeechpp_tpu/ops/pallas_ampblock.py:_kernel and
// pallas_amp_triple.py:_kernel on bf16 activations, whose convs run on the
// MXU at Precision.DEFAULT (bf16 operands, float32 sums). The float32
// configuration stays in snake_conv.cu (split TF32).
//
// Bound on the H100 (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s float32,
// 3.35 TB/s): per output sample 2 K Cin conv flops on the tensor cores and
// about 58 float32 flops of snake (two 6-tap up filters, two sines, the
// 12-tap down filter) on the CUDA cores, plus x, res and y once through
// device memory. At C = 128, k = 11 the tensor cores bound (2816 against 58
// flops, 2.8 : 0.9 ns per sample and channel); at C = 16-32 (the Generator's
// last stages, SpeechSR) the snake's float32 work does. Measured (PERF.md):
// 3-5 x that bound at bench.py's stage shapes, the producers' snake and
// the consumers' taps about even (chip_smoke's snake_conv_bf16_split).
//
// Design. One persistent block per SM walks output tiles of TM time samples
// x TN output channels (ops/ampblock.py:snake_conv_bf16_plan mirrors the
// plan; snake_conv_bf16_plan below is what the card runs). Its 512 threads,
// 16 warps, 4 on each sub-partition so that a thread may hold 128
// registers, have two roles:
//   - 8 producer warps: the snake window of the next tile, float32, written
//     as bf16 into one of two window slots. Lane = channel, a warp's lanes
//     split into runs of rows; each lane slides down its rows with the 12
//     down-filter inputs and the 6 x rows the next two need in registers
//     (unrolled by 6 rows, so the rings never move), one x row loaded per
//     output row, prefetched a group ahead, straight from device memory.
//     The sine is __sinf (snake_fast: the checks hold with it, and sinf's
//     range reduction made the row's dependent chain the bottleneck);
//   - 2 consumer warpgroups: wgmma.mma_async m64nTNk16 (bf16 in, float32
//     accumulate) over the window of the previous tile, a 64-row sub-block
//     per warpgroup and up to MS sub-blocks each. Tap j's whole Cin is one
//     wgmma group: Cin / 16 instructions per sub-block (KS, a template
//     argument, so the chain is unrolled), committed together; two groups
//     stay in flight. The epilogue adds bias and residual and writes y, two
//     columns a store.
// The weights come packed once per parameter version (ops/ampblock.py:
// pack_bf16): rounded, zero-padded to Cin, Cout in {16, 32, 64, 128}, and
// laid out as the B operand's 8 x 8 core matrices, so a tap's (TN x Cin)
// slice is one contiguous run of bytes that cp.async.bulk (the TMA's bulk
// copy) lands in a slot whose mbarrier counts its bytes (a tensor map
// would describe nothing more, so none is encoded). Where all K slices fit
// beside the windows and a tile has all of Cout, they are loaded once and
// stay (C <= 64, and C = 128 at k = 3); else they stream through a ring of
// 4 (or 2) slots, each with an empty mbarrier (one arrival per consumer
// warpgroup): consumer thread 0 refills a slot once both warpgroups have
// released it, 2 taps ahead of the products.
// So the snake of tile i + 1 runs while the tensor cores run tile i, and
// the weights arrive taps ahead; no block-wide barrier in the loop. Each
// mbarrier counts one arrival per warp (window written) or warpgroup (read):
// 256 arrivals a barrier, one per thread, cost more than the tile's
// products.
//
// The A operand (the window) is read from shared memory through a wgmma
// descriptor in the no-swizzle (interleave) K-major layout: 8 channels of a
// row are 16 bytes, rows follow at 16 bytes, and the 8-channel groups at
// WR x 16 bytes (LBO; SBO 128 bytes between 8-row core matrices). Tap j
// reads the window shifted by j d rows, which moves the descriptor's start
// by j d x 16 bytes: any shift keeps every core matrix 8 contiguous rows, so
// every d and tap is exact (the on-card tests run d = 1, 3, 5 at every k
// and T). A swizzled layout would need its base-offset field at shifts that
// are not a multiple of 8 rows; A from registers would cost an ldmatrix
// pass per tap. WR = W rounded up to 8, + 2, puts the four 8-channel groups
// a warp writes on distinct banks.
//
// Resources (ptxas -v, build/kernels/build.log): 104-128 registers, no
// spills; dynamic shared memory 2 windows of Cin_p x WR bf16 + ring x TN x
// Cin_p bf16 + the mbarriers: 226,400 bytes at C = 128, k = 11, d = 5 (TM
// 128, ring 4), the largest plan.
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "taps.cuh"

namespace {

constexpr int kConsumers = 256;  // two warpgroups: the wgmma products
constexpr int kProducers = 256;  // eight warps: the snake window
// mbarrier arrivals: one per producer warp (a window written), one per
// consumer warpgroup (a window or a weight slice read)
constexpr int kProducerWarps = kProducers / 32;
constexpr int kConsumerGroups = kConsumers / 128;
// 16 warps, 4 on each of the SM's sub-partitions, so that a thread may
// hold 128 registers (a 17th warp would cap them at 96 and spill the
// accumulators)
constexpr int kThreads = kConsumers + kProducers;
constexpr int kWinSlots = 2;

// snake_conv_bf16_fwd's `io` flags: those of snake_conv.cu, the first
// (the bf16 products) required
constexpr int kBf16Mma = 1;
constexpr int kXBf16 = 2;
constexpr int kResBf16 = 4;
constexpr int kYBf16 = 8;

// channels padded for the products: Cin to the wgmma K steps, Cout to its N
__host__ __device__ constexpr int pad_c(int c) {
  return c <= 16 ? 16 : c <= 32 ? 32 : c <= 64 ? 64 : 128;
}

// 64-row sub-blocks a consumer warpgroup keeps in registers: MS x N / 2
// float32 accumulators a thread
__host__ __device__ constexpr int ms_max(int n) {
  return n >= 128 ? 1 : n == 64 ? 2 : 4;
}

struct Plan {
  int tm, tn, cinp, coutp, ring, wr, smem, tiles, grid;
};

// The tile plan (ops/ampblock.py:snake_conv_bf16_plan is its mirror): the
// largest TM of 128 MS_max(Cout_p) .. 128 with B ceil(T / TM) >= sms tiles
// of all of Cout; else TM 64, with Cout split (down to 16 channels a tile)
// while the card is not full. The weight ring holds all K taps where they
// fit beside the windows and the tile has all of Cout (loaded once), else
// streams through 4 slots, or 2. 0 when no plan fits.
int plan_of(int B, int T, int Cin, int Cout, int K, int dil, int sms,
            int smem_max, Plan* p) {
  if (B < 1 || T < 1 || Cin < 1 || Cin > 128 || Cout < 1 || Cout > 128 ||
      K < 1 || dil < 1 || (long)(K - 1) * dil > 4096)
    return 0;
  const int cinp = pad_c(Cin), coutp = pad_c(Cout);
  auto wr_of = [&](int tm) { return (tm + (K - 1) * dil + 7) / 8 * 8 + 2; };
  auto smem_of = [&](int tm, int tn, int ring) {
    return 4L * cinp * wr_of(tm) + 2L * ring * tn * cinp +
           8L * (2 * kWinSlots + 2 * ring);
  };
  auto ring_of = [&](int tm, int tn) {  // all K taps resident, else 4, 2
    if (tn == coutp && smem_of(tm, tn, K) <= smem_max) return K;
    for (int r : {4, 2})
      if (smem_of(tm, tn, r) <= smem_max) return r;
    return 0;
  };
  auto rows = [&](int tm) { return (long)B * ((T + tm - 1) / tm); };
  int tm = 0, tn = coutp;
  for (int m = ms_max(coutp); m >= 1 && !tm; --m)
    if (ring_of(128 * m, tn) && rows(128 * m) >= sms) tm = 128 * m;
  if (!tm) {
    tm = 64;
    while (tn > 16 && (!ring_of(tm, tn) || rows(tm) * (coutp / tn) < sms))
      tn /= 2;
  }
  const int ring = ring_of(tm, tn);
  if (!ring || tn > cinp) return 0;  // built for N <= Cin_p
  const long tiles = rows(tm) * (coutp / tn);
  if (tiles > (1L << 30)) return 0;
  *p = {tm, tn, cinp, coutp, ring, wr_of(tm), (int)smem_of(tm, tn, ring),
        (int)tiles, (int)(tiles < sms ? tiles : sms)};
  return 1;
}

// ---- PTX: mbarriers, the bulk copy, wgmma ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  [[maybe_unused]] uint64_t state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];"
               : "=l"(state)
               : "r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  [[maybe_unused]] uint64_t state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;"
               : "=l"(state)
               : "r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of `parity` has completed (a fresh barrier counts its
// phase before the first as complete, so parity 1 passes at once).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// generic-proxy writes to shared memory made visible to the async proxy
// (wgmma's operand reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A wgmma shared-memory descriptor, no swizzle: start, LBO (between the two
// 8-element K halves of a k16 step), SBO (between 8-row core matrices), in
// 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// pins an accumulator register's reads and writes on this side of a
// wgmma fence or wait
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// D (64 x N, float32) += A (64 x 16, bf16, descriptor) * B (16 x N, bf16,
// descriptor, K-major), or = with scale_d 0.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
// ---- the kernel ----

// SnakeBeta with the SFU's sine (__sinf: sin.approx after a float32 range
// scaling). Its error, under 2^-21 for |alpha u| <= pi and growing with
// |alpha u| beyond, is far below the bf16 rounding the window takes next;
// it moves a window value across a bf16 boundary only where the value lies
// within that error of one, and the per-launch checks (2^-8 x max|ref| of
// the twin, 1e-4 x mean|ref| in mean error for float32 outputs) hold with
// it. The float32 kernels keep sinf (taps.cuh).
__device__ __forceinline__ float snake_fast(float u, float alpha,
                                            float inv_beta) {
  const float s = __sinf(u * alpha);
  return u + s * s * inv_beta;
}

template <bool XB16>
__device__ __forceinline__ float ld_x(const void* xb, size_t i) {
  if constexpr (XB16)
    return ld_act(static_cast<const bf16*>(xb) + i);
  else
    return ld_act(static_cast<const float*>(xb) + i);
}

template <int N, int KS, bool XB16>
__global__ void __launch_bounds__(kThreads, 1)
snake_conv_bf16_kernel(const void* __restrict__ x,
                       const float* __restrict__ alpha,
                       const float* __restrict__ inv_beta,
                       const uint16_t* __restrict__ wp,  // packed bf16
                       const float* __restrict__ bias,
                       const void* __restrict__ res, void* __restrict__ y,
                       int T, int Cin, int Cout, int K, int dil, int io,
                       Plan pl, long long* __restrict__ stamps) {
  constexpr int MS = ms_max(N);
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int tm = pl.tm, cinp = pl.cinp, wr = pl.wr, ring = pl.ring;
  const int W = tm + (K - 1) * dil;  // window rows
  const int hd = (K - 1) / 2 * dil;
  const int n_rt = (T + tm - 1) / tm, n_ct = pl.coutp / N;
  const uint32_t win_bytes = (uint32_t)cinp * wr * 2;
  const uint32_t wslot_bytes = (uint32_t)N * cinp * 2;
  const uint32_t base = smem_addr(smem);
  const uint32_t wring = base + kWinSlots * win_bytes;
  const uint32_t bars = wring + ring * wslot_bytes;
  // barriers: window full [2], window empty [2], weight full [ring], weight
  // empty [ring]
  auto win_full = [&](int s) { return bars + 8 * s; };
  auto win_empty = [&](int s) { return bars + 8 * (kWinSlots + s); };
  auto w_full = [&](int s) { return bars + 8 * (2 * kWinSlots + s); };
  auto w_empty = [&](int s) { return bars + 8 * (2 * kWinSlots + ring + s); };

  if (tid == 0) {
    for (int s = 0; s < kWinSlots; ++s) {
      mbar_init(win_full(s), kProducerWarps);
      mbar_init(win_empty(s), kConsumerGroups);
    }
    for (int s = 0; s < ring; ++s) {
      mbar_init(w_full(s), 1);
      mbar_init(w_empty(s), kConsumerGroups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();

  // stamps (a diagnostic, null on the path): SM cycles per block, summed
  // over its tiles: [0] producer warp 0 waiting for a free window, [1] it
  // writing the window; consumer thread 0: [2] waiting for the window, [3]
  // waiting for weight slices, [4] the taps' products and releases, [5] the
  // epilogue; [6] the whole block, [7] its tiles
  long long* st = stamps ? stamps + 8 * blockIdx.x : nullptr;
  const long long t_start = clock64();

  // tile -> (batch row, first time sample, first output channel)
  auto tile_at = [&](int tile, int* b, int* t0, int* n0) {
    *n0 = tile % n_ct * N;
    const int rt = tile / n_ct;
    *t0 = rt % n_rt * tm;
    *b = rt / n_rt;
  };

  // the q-th weight slice of this block: tap q % K of its (q / K)-th tile,
  // into slot q % ring (issued by consumer thread 0)
  const int n_q = (pl.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * K;
  auto load_slice = [&](int q) {
    int b, t0, n0;
    tile_at(blockIdx.x + q / K * gridDim.x, &b, &t0, &n0);
    const int s = q % ring;
    mbar_expect_tx(w_full(s), wslot_bytes);
    bulk_copy(wring + s * wslot_bytes,
              wp + ((size_t)(q % K) * (pl.coutp / 8) + n0 / 8) * (cinp / 8) * 64,
              wslot_bytes, w_full(s));
  };

  if (tid >= kConsumers) {  // ---- the snake ----
    const int pt = tid - kConsumers, pw = pt >> 5, lane = pt & 31;
    const int cw = cinp < 32 ? cinp : 32;  // channels of a lane group
    const int gi = pw * (32 / cw) + lane / cw;
    const int chunks = cinp / cw, nseg = kProducers / cinp;
    const int c = gi % chunks * cw + lane % cw, seg = gi / chunks;
    const bool cok = c < Cin;
    const float a = cok ? alpha[c] : 0.f, ib = cok ? inv_beta[c] : 0.f;
    const int ra = seg * W / nseg, rb = (seg + 1) * W / nseg;
    // this lane's column of the window: channel c, 2-byte rows of 16 bytes
    const uint32_t col = (uint32_t)((c >> 3) * wr * 16 + (c & 7) * 2);
    int it = 0;
    for (int tile = blockIdx.x; tile < pl.tiles; tile += gridDim.x, ++it) {
      int b, t0, n0;
      tile_at(tile, &b, &t0, &n0);
      const int slot = it & 1;
      const long long c0 = clock64();
      mbar_wait(win_empty(slot), ((it >> 1) & 1) ^ 1);
      const long long c1 = clock64();
      const int w0 = t0 - hd;
      const void* xb =
          XB16 ? (const void*)(static_cast<const bf16*>(x) + (size_t)b * T * Cin)
               : (const void*)(static_cast<const float*>(x) + (size_t)b * T * Cin);
      auto X = [&](int p) {  // x at clamp(p): the replicate pad
        return cok ? ld_x<XB16>(xb, (size_t)clampi(p, 0, T - 1) * Cin + c) : 0.f;
      };
      const int pa = w0 + ra;
      // s(u[0]) and s(u[2T - 1]) stand in where a u index leaves [0, 2T)
      float s_lo = 0.f, s_hi = 0.f;
      if (pa < 8) {  // u[0] = sum kUpEven[i] x[clamp(i - 3)]
        float u = 0.f;
#pragma unroll
        for (int i = 0; i < 6; ++i) u += kUpEven[i] * X(i - 3);
        s_lo = snake_fast(u, a, ib);
      }
      if (w0 + rb + 12 > T) {  // u[2T - 1] = sum kUpOdd[i] x[clamp(T - 3 + i)]
        float u = 0.f;
#pragma unroll
        for (int i = 0; i < 6; ++i) u += kUpOdd[i] * X(T - 3 + i);
        s_hi = snake_fast(u, a, ib);
      }
      // the 12 down-filter inputs of the first row, s(u[2 pa - 5 + k]), from
      // x[pa - 6 .. pa + 5]
      float S[12], Xr[6], L[6];
      {
        float xw[12];
#pragma unroll
        for (int i = 0; i < 12; ++i) xw[i] = X(pa - 6 + i);
#pragma unroll
        for (int k = 0; k < 12; ++k) {
          const int j = 2 * pa - 5 + k;
          float u = 0.f;
#pragma unroll
          for (int i = 0; i < 6; ++i)
            u += (k & 1 ? kUpEven[i] : kUpOdd[i]) * xw[1 + k / 2 + i];
          S[k] = j < 0 ? s_lo : (j > 2 * T - 1 ? s_hi : snake_fast(u, a, ib));
        }
#pragma unroll
        for (int m = 1; m < 6; ++m) Xr[m] = xw[6 + m];
        Xr[0] = 0.f;
#pragma unroll
        for (int i = 0; i < 6; ++i) L[i] = X(pa + 6 + i);
      }
      unsigned char* wcol = smem + slot * win_bytes + col;
      // Groups of 6 rows, unrolled, so that the rings never move: row p0 + i
      // finds s(u[2p - 5 + k]) in S[(2i + k) % 12] and x[p + m] in Xr[(i + m)
      // % 6], m = 1..5; L holds the group's x[p + 6], loaded a group ahead.
      for (int r0 = ra; r0 < rb; r0 += 6) {
        const int p0 = w0 + r0;
        float LN[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) LN[i] = X(p0 + 12 + i);
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const int p = p0 + i;
          float v0 = 0.f, v1 = 0.f;  // two chains of the down filter
#pragma unroll
          for (int k = 0; k < 12; k += 2) {
            v0 += kDown[k] * S[(2 * i + k) % 12];
            v1 += kDown[k + 1] * S[(2 * i + k + 1) % 12];
          }
          const float v = p >= 0 && p < T ? v0 + v1 : 0.f;  // zero padding
          if (r0 + i < rb)
            *reinterpret_cast<unsigned short*>(wcol + (r0 + i) * 16) =
                bf16_bits(v);
          // the next row's two new inputs, u[2p + 7] and u[2p + 8], both
          // from x[p + 1 .. p + 6]
          Xr[i] = L[i];
          float uo = 0.f, ue = 0.f;
#pragma unroll
          for (int m = 0; m < 6; ++m) {
            const float xv = Xr[(i + 1 + m) % 6];
            uo += kUpOdd[m] * xv;
            ue += kUpEven[m] * xv;
          }
          const int j = 2 * p + 7;
          S[(2 * i) % 12] =
              j < 0 ? s_lo : (j > 2 * T - 1 ? s_hi : snake_fast(uo, a, ib));
          S[(2 * i + 1) % 12] =
              j + 1 < 0 ? s_lo : (j + 1 > 2 * T - 1 ? s_hi : snake_fast(ue, a, ib));
        }
#pragma unroll
        for (int i = 0; i < 6; ++i) L[i] = LN[i];
      }
      fence_proxy_async();  // each lane's window writes, then the warp's
      __syncwarp();
      if (lane == 0) mbar_arrive(win_full(slot));
      if (st != nullptr && pt == 0) {
        st[0] += c1 - c0;
        st[1] += clock64() - c1;
      }
    }
  } else {  // ---- the products ----
    const int wg = tid >> 7, tw = tid & 127;
    // slice q read by this warpgroup: thread 0 of each signals it, and
    // thread 0 of the block, once both have, refills the slot with slice
    // q + ring
    auto release = [&](int q) {
      if (tw == 0) {
        mbar_arrive(w_empty(q % ring));
        if (tid == 0 && q + ring < n_q) {
          mbar_wait(w_empty(q % ring), (q / ring) & 1);
          load_slice(q + ring);
        }
      }
      __syncwarp();  // the warp converged again before its next wgmma
    };
    const int nca = tm == 64 ? 1 : 2;  // warpgroups with rows
    const int msub = tm / (64 * nca);  // 64-row sub-blocks each
    const bool rows = wg < nca;
    // the epilogue's paired stores: Cout even and the rows 8-byte aligned
    const bool vec = Cout % 2 == 0 && (uintptr_t)y % 8 == 0 &&
                     (uintptr_t)res % ((io & kResBf16) ? 4 : 8) == 0;
    // tap groups in flight: 2 where the ring has 4 slots (the slices of
    // both and the next two resident), else 1
    const int depth = ring >= 4 ? 2 : 1;
    // every tap's slice in its own slot, the same for every tile: loaded
    // once, never released
    const bool resident = ring == K && n_ct == 1;
    float acc[MS][N / 2];
#pragma unroll
    for (int m = 0; m < MS; ++m)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[m][i] = 0.f;
    if (tid == 0)  // the first slices; later ones as the slots come free
      for (int q = 0; q < ring && q < n_q; ++q) load_slice(q);
    int it = 0, q = 0;
    for (int tile = blockIdx.x; tile < pl.tiles; tile += gridDim.x, ++it) {
      int b, t0, n0;
      tile_at(tile, &b, &t0, &n0);
      const int slot = it & 1;
      long long c0 = clock64();
      mbar_wait(win_full(slot), (it >> 1) & 1);
      long long c1 = clock64(), c_w = 0;
      const uint32_t win = base + slot * win_bytes;
      for (int j = 0; j < K; ++j, ++q) {
        const int s = q % ring;
        const long long c2 = clock64();
        if (!resident || it == 0) mbar_wait(w_full(s), (q / ring) & 1);
        c_w += clock64() - c2;
        if (rows) {
#pragma unroll
          for (int m = 0; m < MS; ++m)
#pragma unroll
            for (int i = 0; i < N / 2; ++i) fence_reg(acc[m][i]);
          wgmma_fence();
          const uint32_t wslot = wring + s * wslot_bytes;
#pragma unroll
          for (int m = 0; m < MS; ++m) {
            if (m < msub) {
              const int row = (wg * msub + m) * 64 + j * dil;
#pragma unroll
              for (int kk = 0; kk < KS; ++kk)
                Wgmma<N>::mma(acc[m],
                              desc(win + (2 * kk * wr + row) * 16, wr * 16, 128),
                              desc(wslot + kk * 256, 128, KS * 256),
                              j > 0 || kk > 0);
            }
          }
          wgmma_commit();
#pragma unroll
          for (int m = 0; m < MS; ++m)
#pragma unroll
            for (int i = 0; i < N / 2; ++i) fence_reg(acc[m][i]);
        }
        if (!resident && j >= depth) {  // tap j - depth's group has read its slot
          if (rows) {
            if (depth == 2)
              wgmma_wait<2>();
            else
              wgmma_wait<1>();
          }
          release(q - depth);
        }
      }
      if (rows) wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < MS; ++m)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) fence_reg(acc[m][i]);
      if (!resident)
        for (int r = q - (K < depth ? K : depth); r < q; ++r) release(r);
      if (tw == 0) mbar_arrive(win_empty(slot));
      const long long c3 = clock64();
      if (st != nullptr && tid == 0) {
        st[2] += c1 - c0;
        st[3] += c_w;
        st[4] += c3 - c1 - c_w;
        st[7] += 1;
      }
      if (!rows) continue;
      // the accumulator of m64nNk16: d[i] at row 16 warp + lane / 4 + 8 ((i
      // / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2: a thread's two
      // neighbouring columns go out as one 8-byte (4-byte bf16) store where
      // the rows allow it
      const int w = tw >> 5, g = (tw & 31) >> 2, t4 = tw & 3;
      const bool r16 = io & kResBf16, y16 = io & kYBf16;
#pragma unroll
      for (int n8 = 0; n8 < N / 8; ++n8) {
        const int co = n0 + 8 * n8 + 2 * t4;
        if (co >= Cout) continue;
        const bool two = co + 1 < Cout;
        const float b0 = bias[co], b1 = two ? bias[co + 1] : 0.f;
#pragma unroll
        for (int m = 0; m < MS; ++m) {
          if (m >= msub) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = t0 + (wg * msub + m) * 64 + 16 * w + g + 8 * h;
            if (t >= T) continue;
            const size_t o = ((size_t)b * T + t) * Cout + co;
            float v0 = acc[m][4 * n8 + 2 * h] + b0;
            float v1 = acc[m][4 * n8 + 2 * h + 1] + b1;
            if (vec) {  // Cout even: o even, both columns in the row
              if (res != nullptr) {
                if (r16) {
                  const uint32_t r2 = __ldg(reinterpret_cast<const unsigned*>(
                      static_cast<const bf16*>(res) + o));
                  v0 += __uint_as_float(r2 << 16);
                  v1 += __uint_as_float(r2 & 0xffff0000u);
                } else {
                  const float2 r2 = __ldg(reinterpret_cast<const float2*>(
                      static_cast<const float*>(res) + o));
                  v0 += r2.x;
                  v1 += r2.y;
                }
              }
              if (y16)
                *reinterpret_cast<unsigned*>(static_cast<bf16*>(y) + o) =
                    (unsigned)bf16_bits(v0) | ((unsigned)bf16_bits(v1) << 16);
              else
                *reinterpret_cast<float2*>(static_cast<float*>(y) + o) =
                    make_float2(v0, v1);
              continue;
            }
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (e == 1 && !two) continue;
              float v = e ? v1 : v0;
              if (res != nullptr)
                v += r16 ? ld_act(static_cast<const bf16*>(res) + o + e)
                         : ld_act(static_cast<const float*>(res) + o + e);
              if (y16)
                st_act(static_cast<bf16*>(y) + o + e, v);
              else
                static_cast<float*>(y)[o + e] = v;
            }
          }
        }
      }
      if (st != nullptr && tid == 0) st[5] += clock64() - c3;
    }
    if (st != nullptr && tid == 0) st[6] = clock64() - t_start;
  }
}

template <int N, int KS, bool XB16>
int launch(const Plan& pl, const void* x, const float* alpha,
           const float* inv_beta, const uint16_t* wp, const float* bias,
           const void* res, void* y, int T, int Cin, int Cout, int K, int dil,
           int io, long long* stamps, cudaStream_t stream) {
  auto kernel = snake_conv_bf16_kernel<N, KS, XB16>;
  static int smem_set = 48 * 1024;
  if (pl.smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = pl.smem;
  }
  kernel<<<pl.grid, kThreads, pl.smem, stream>>>(x, alpha, inv_beta, wp, bias,
                                                 res, y, T, Cin, Cout, K, dil,
                                                 io, pl, stamps);
  return (int)cudaGetLastError();
}

int card_plan(int B, int T, int Cin, int Cout, int K, int dil, Plan* p) {
  static int sms = 0, smem_max = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  }
  return plan_of(B, T, Cin, Cout, K, dil, sms, smem_max, p);
}

}  // namespace

// The plan of a launch on the current card, as 9 ints: TM, TN, Cin_p,
// Cout_p, ring slots, WR, shared bytes, tiles, grid.
extern "C" int snake_conv_bf16_plan(int B, int T, int Cin, int Cout, int K,
                                    int dil, int* out) {
  Plan p;
  if (!card_plan(B, T, Cin, Cout, K, dil, &p)) return (int)cudaErrorInvalidValue;
  const int v[9] = {p.tm, p.tn, p.cinp, p.coutp, p.ring, p.wr, p.smem, p.tiles,
                    p.grid};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// x (B, T, Cin) float32 or bf16; wp the packed bf16 weights, (K, Cout_p / 8,
// Cin_p / 8, 8, 8); res (B, T, Cout) or null; y (B, T, Cout). io: kBf16Mma
// with kXBf16 / kResBf16 / kYBf16 for bf16 x / res / y. stamps: null, or 8
// zeroed int64 per block of the plan's grid (the kernel's phase split).
extern "C" int snake_conv_bf16_fwd(const void* x, const float* alpha,
                                   const float* inv_beta, const void* wp,
                                   const float* bias, const void* res,
                                   void* y, int B, int T, int Cin, int Cout,
                                   int K, int dil, int io, long long* stamps,
                                   void* stream) {
  if (!(io & kBf16Mma) || (io & ~(kBf16Mma | kXBf16 | kResBf16 | kYBf16)) ||
      (uintptr_t)wp % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Plan p;
  if (!card_plan(B, T, Cin, Cout, K, dil, &p)) return (int)cudaErrorInvalidValue;
  const auto* w = static_cast<const uint16_t*>(wp);
  cudaStream_t s = (cudaStream_t)stream;
  const bool x16 = io & kXBf16;
#define SNAKE_CONV_BF16_CASE(N, KS)                                           \
  if (p.tn == N && p.cinp == 16 * KS)                                         \
    return x16 ? launch<N, KS, true>(p, x, alpha, inv_beta, w, bias, res, y,  \
                                     T, Cin, Cout, K, dil, io, stamps, s)     \
               : launch<N, KS, false>(p, x, alpha, inv_beta, w, bias, res, y, \
                                      T, Cin, Cout, K, dil, io, stamps, s);
  SNAKE_CONV_BF16_CASE(128, 8)
  SNAKE_CONV_BF16_CASE(64, 8)
  SNAKE_CONV_BF16_CASE(32, 8)
  SNAKE_CONV_BF16_CASE(16, 8)
  SNAKE_CONV_BF16_CASE(64, 4)
  SNAKE_CONV_BF16_CASE(32, 4)
  SNAKE_CONV_BF16_CASE(16, 4)
  SNAKE_CONV_BF16_CASE(32, 2)
  SNAKE_CONV_BF16_CASE(16, 2)
  SNAKE_CONV_BF16_CASE(16, 1)
#undef SNAKE_CONV_BF16_CASE
  return (int)cudaErrorInvalidValue;
}
