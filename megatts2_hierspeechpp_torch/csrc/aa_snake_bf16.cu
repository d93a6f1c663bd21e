// Anti-aliased SnakeBeta in the TPU kernel's bf16 configuration,
// y = down2(s(up2(x))) on (B, T, C) bf16 x and y, every tap and the snake
// in float32 with float32 alpha and 1/beta.
//
// Replaces megatts2_hierspeechpp_tpu/ops/pallas_snake.py (_kernel,
// _kernel_tr behind fused_aa_snakebeta) on a bf16 x. The float32
// configuration is aa_snake.cu, whose bf16 arm this kernel took over.
//
// The bytes bound is 4 bytes an element (a bf16 read and a bf16 write), so
// at the vocoder's shapes the arithmetic, not the memory, bounds it.
// aa_snake.cu's register window (R outputs a thread from R + 10 rows,
// 2R + 10 s(u)) computes 3.25 s(u) an output where 2 are needed, with
// sinf, and loads each row as a 16-bit scalar. This kernel streams
// instead: a thread owns 2 neighbouring channels (one packed bf16x2 word a
// row, so a warp's row is 128 contiguous bytes; 1 channel where C is odd
// or x is not 4-byte aligned) and a segment of `seg` consecutive outputs,
// and walks it one row at a time. Step m loads x row t0 + m, computes the
// pair
//   P_k = (s(u[2k - 5]), s(u[2k - 4])),  k = t0 + m,
// (both from the same six rows x[k - 5 .. k]: the odd phase of the x2
// upsampler on kUpOdd, the even phase on kUpEven) and, from step 5 on,
// emits y[k - 5] = sum_j kDown[2j] P_{k-5+j}.odd + kDown[2j+1] P_{k-5+j}.even
// with the last six pairs. Each s(u) is computed once per segment: 2 an
// output, plus 10 per segment for the 5 pairs before its first output. The
// rows and pairs live in six-slot register rings; the loop body is six
// steps, so every slot index is a compile-time constant and the ring never
// moves a register (a segment is a whole number of bodies). Each step
// loads the row of the same step of the next body into the word it has
// just unpacked, so six rows are in flight while a body computes. An
// output costs 12 FFMA for its two u, two snakes and 12 FFMA for the down
// filter; the segment length trades the 5 extra pairs against the
// warps that fill the card (snake_bf16_plan; chip_smoke.py's kernel_bf16
// lines sweep it).
// The snake's sine is the hardware's (taps.cuh snake_bf16), far inside
// the bf16 gate of 2^-8 x max|ref|, about 2^-8 |u| at least; sinf, which
// the float32 arm must take, costs some 40 instructions more a call and
// gave the same largest error at every bf16 launch shape (PERF.md).
//
// Sequence edges follow taps.cuh: x indices clamp to [0, T - 1] and u
// indices to [0, 2T - 1]. Only the 5 pairs before a segment's first output
// can reach u < 0 (the first segment), and only a segment whose rows run
// past T - 1 reaches u > 2T - 1; there s(u[0]) and s(u[2T - 1]) stand in
// for the clamped pairs, and that segment's loop clamps its loads and masks
// its stores. Segments away from the end run a copy of the loop without
// either test.
//
// The launch plan (seg, the packing and the grid) is
// ops/snake.py:snake_bf16_plan; the entry point recomputes the grid and
// refuses a plan that disagrees or that it was not built for.
#include <cuda_runtime.h>

#include "taps.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps, each one (channel chunk, segment)
constexpr int kPeriod = 6;     // steps in the loop body: the rings' length
constexpr int kMaxSeg = 384;   // outputs a thread, a multiple of kPeriod

// One row of P channels (P = 2: a packed bf16x2 word; P = 1: one bf16).
template <int P>
__device__ __forceinline__ unsigned ld_row(const bf16* p) {
  if (P == 2) return __ldg(reinterpret_cast<const unsigned*>(p));
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

template <int P>
__device__ __forceinline__ void unpack(unsigned w, float (&v)[P]) {
  v[0] = __uint_as_float(w << 16);
  if (P == 2) v[P - 1] = __uint_as_float(w & 0xffff0000u);
}

template <int P>
__device__ __forceinline__ void st_row(bf16* p, const float (&v)[P]) {
  if (P == 2) {  // round to nearest even, both halves in one instruction
    unsigned w;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(w) : "f"(v[P - 1]), "f"(v[0]));
    *reinterpret_cast<unsigned*>(p) = w;
  } else {
    unsigned short h;
    asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(h) : "f"(v[0]));
    *reinterpret_cast<unsigned short*>(p) = h;
  }
}

template <int P>
struct Segment {
  const bf16* xb;  // x at (b, 0, c0)
  bf16* yb;
  int T, C, t0;
  float al[P], ib[P], s_lo[P], s_hi[P];
  float xs[kPeriod][P];  // x row t0 - 5 + r in slot r % 6
  float so[kPeriod][P];  // pair t0 + m in slot m % 6: s(u[2k - 5])
  float se[kPeriod][P];  //                           s(u[2k - 4])

  __device__ __forceinline__ unsigned load(int q, bool clamp) const {
    if (clamp) q = clampi(q, 0, T - 1);
    return ld_row<P>(xb + (size_t)q * C);
  }

  // Pair m into slot M = m % 6 from the rows in slots M .. M + 5; with
  // kEdge, the u indices outside [0, 2T - 1] take s_lo / s_hi.
  template <int M, bool kEdge>
  __device__ __forceinline__ void pair_at(int m) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float uo = 0.f, ue = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float v = xs[(M + i) % kPeriod][p];
        uo += kUpOdd[i] * v;
        ue += kUpEven[i] * v;
      }
      float a = snake_bf16(uo, al[p], ib[p]);
      float e = snake_bf16(ue, al[p], ib[p]);
      if (kEdge) {
        const int j = 2 * (t0 + m) - 5;  // u index of the odd member
        a = j < 0 ? s_lo[p] : (j > 2 * T - 1 ? s_hi[p] : a);
        e = j + 1 < 0 ? s_lo[p] : (j + 1 > 2 * T - 1 ? s_hi[p] : e);
      }
      so[M][p] = a;
      se[M][p] = e;
    }
  }

  // y[t0 + m - 5], at `row`, from the pairs m - 5 .. m, whose slots start
  // at M0.
  template <int M0, bool kMask>
  __device__ __forceinline__ void emit(int m, bf16* row) {
    if (kMask && t0 + m - 5 >= T) return;
    float out[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        acc += kDown[2 * j] * so[(M0 + j) % kPeriod][p];
        acc += kDown[2 * j + 1] * se[(M0 + j) % kPeriod][p];
      }
      out[p] = acc;
    }
    st_row<P>(row, out);
  }

  // Steps 5 .. seg + 4 in bodies of six; kEnd: the segment's rows reach
  // past T - 1 (clamped loads, s_hi, masked stores). Away from the end the
  // rows are addressed by pointers advanced a row a step, which keeps the
  // 64-bit row products out of the loop.
  template <bool kEnd>
  __device__ __forceinline__ void run(int seg, unsigned (&pf)[kPeriod]) {
    const int bodies = seg / kPeriod;
    const bf16* xp = xb + (size_t)(t0 + 5 + kPeriod) * C;  // next body's rows
    bf16* yp = yb + (size_t)t0 * C;                         // output rows
    for (int n = 0; n < bodies; ++n) {
      const int m0 = 5 + kPeriod * n;
      const bool more = n + 1 < bodies;
#define AA_STEP(J)                                                        \
  {                                                                       \
    unpack<P>(pf[J], xs[(J + 4) % kPeriod]);                              \
    if (more)                                                             \
      pf[J] = kEnd ? load(t0 + m0 + kPeriod + J, true) : ld_row<P>(xp);   \
    xp += C;                                                              \
    pair_at<(J + 5) % kPeriod, kEnd>(m0 + J);                             \
    emit<J, kEnd>(m0 + J, yp);                                            \
    yp += C;                                                              \
  }
      AA_STEP(0) AA_STEP(1) AA_STEP(2) AA_STEP(3) AA_STEP(4) AA_STEP(5)
#undef AA_STEP
    }
  }
};

// At most kThreads threads, and registers for 2 blocks an SM: the compiler
// then keeps more of a body's independent chains in flight than at its
// default budget, which trades them for resident blocks.
template <int P>
__global__ void __launch_bounds__(kThreads, 2)
aa_snakebeta_bf16_kernel(const bf16* __restrict__ x,
                         const float* __restrict__ alpha,
                         const float* __restrict__ inv_beta,
                         bf16* __restrict__ y, int B, int T, int C, int seg,
                         int chunks, int segs) {
  // warps run channel chunk fastest, then segment, then batch row
  const int warp = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int chunk = warp % chunks, rest = warp / chunks;
  const int b = rest / segs;
  const int c0 = (chunk * 32 + (threadIdx.x & 31)) * P;
  if (b >= B || c0 >= C) return;
  Segment<P> s;
  s.T = T;
  s.C = C;
  s.t0 = (rest % segs) * seg;
  s.xb = x + (size_t)b * T * C + c0;
  s.yb = y + (size_t)b * T * C + c0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    s.al[p] = __ldg(alpha + c0 + p);
    s.ib[p] = __ldg(inv_beta + c0 + p);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) s.s_lo[p] = s.s_hi[p] = 0.f;
  const int t0 = s.t0;
  const bool end = t0 + seg + 4 >= T;
  // the first body's rows, in flight through the prologue
  unsigned pf[kPeriod];
#pragma unroll
  for (int j = 0; j < kPeriod; ++j) pf[j] = s.load(t0 + 5 + j, end);
  // s(u[0]) and s(u[2T - 1]) where this segment's pairs reach an edge
  if (t0 < 3 || end) {
    float xv[6][P];
#pragma unroll
    for (int i = 0; i < 6; ++i) unpack<P>(s.load(i - 3, true), xv[i]);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float u = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i) u += kUpEven[i] * xv[i][p];
      s.s_lo[p] = snake_bf16(u, s.al[p], s.ib[p]);
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) unpack<P>(s.load(T - 3 + i, true), xv[i]);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float u = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i) u += kUpOdd[i] * xv[i][p];
      s.s_hi[p] = snake_bf16(u, s.al[p], s.ib[p]);
    }
  }
  // prologue: rows t0 - 5 .. t0 + 4 and the pairs t0 .. t0 + 4, clamped
#pragma unroll
  for (int r = 0; r < 5; ++r) unpack<P>(s.load(t0 - 5 + r, true), s.xs[r]);
#define AA_PRO(M)                                           \
  unpack<P>(s.load(t0 + M, true), s.xs[(M + 5) % kPeriod]);  \
  s.template pair_at<M, true>(M);
  AA_PRO(0) AA_PRO(1) AA_PRO(2) AA_PRO(3) AA_PRO(4)
#undef AA_PRO
  if (end)
    s.template run<true>(seg, pf);
  else
    s.template run<false>(seg, pf);
}

template <int P>
int launch(const void* x, const float* alpha, const float* inv_beta, void* y,
           int B, int T, int C, int seg, int chunks, int segs, int blocks,
           cudaStream_t stream) {
  aa_snakebeta_bf16_kernel<P><<<blocks, kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), alpha, inv_beta, static_cast<bf16*>(y), B,
      T, C, seg, chunks, segs);
  return (int)cudaGetLastError();
}

}  // namespace

// seg: outputs a thread, a multiple of 6 up to 384; pack: channels a
// thread, 2 (bf16x2 rows: C even, x and y 4-byte aligned) or 1; blocks
// must be the grid of that plan,
// ceil(B * ceil(T / seg) * ceil(C / (32 * pack)) / 4).
extern "C" int aa_snakebeta_bf16_fwd(const void* x, const float* alpha,
                                     const float* inv_beta, void* y, int B,
                                     int T, int C, int seg, int pack,
                                     int blocks, void* stream) {
  if (B < 1 || T < 1 || C < 1 || seg < kPeriod || seg > kMaxSeg ||
      seg % kPeriod)
    return (int)cudaErrorInvalidValue;
  if (pack != 1 && pack != 2) return (int)cudaErrorInvalidValue;
  const size_t align = 2 * (size_t)pack;
  if (C % pack || reinterpret_cast<size_t>(x) % align ||
      reinterpret_cast<size_t>(y) % align)
    return (int)cudaErrorInvalidValue;
  const int chunks = (C + 32 * pack - 1) / (32 * pack);
  const int segs = (T + seg - 1) / seg;
  const long long warps = (long long)B * segs * chunks;
  const long long want = (warps + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks != want || warps > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (pack == 2)
    return launch<2>(x, alpha, inv_beta, y, B, T, C, seg, chunks, segs,
                     blocks, s);
  return launch<1>(x, alpha, inv_beta, y, B, T, C, seg, chunks, segs, blocks,
                   s);
}
