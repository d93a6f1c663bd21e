// Tail of an AMPBlock triple in the TPU kernel's bf16 configuration:
//
//   y = tanh(conv_post(snake(avg))),  avg = (r0 + r1 + r2) / 3
//
// on the three float32 block outputs r0, r1, r2 (B, T, C), written once as
// the bf16 (B, T, 1) waveform. conv_post: C -> 1, k = 7, zero padding 3, no
// bias; snake: the x2 anti-aliased SnakeBeta (taps.cuh). The average, the
// AA-snake, conv_post and tanh run in float32; only the store rounds.
//
// Replaces the tail of megatts2_hierspeechpp_tpu/ops/pallas_amp_triple.py
// (_kernel behind fused_amp_triple) on a bf16 stage. The float32 tail and
// the average alone stay in triple_epilogue.cu.
//
// Bound by bytes on the H100: 12 bytes an element (three float32 reads)
// against about 50 float32 instructions an element once each s(u) is
// computed once with the hardware sine. triple_epilogue.cu's tail, planned
// for float32's error budget, computes 2.6 s(u) an element with sinf in
// three phases split by block barriers and reaches 35-45 % of that bound.
// This kernel streams instead, with no shared tile and no block barrier:
//
// - A group of G lanes (G = 32 at C > 16, else the power of two >= C; 32 /
//   G groups a warp) owns one batch row's segment of `seg` consecutive
//   outputs, t0 .. t0 + seg - 1. Lane l of the group holds channels l + p G
//   (p < P: P = 1 at C <= 32, else 2), so each input row is one coalesced
//   load of G x 4 bytes per channel slot; channels past C read nothing and
//   weigh 0. Wider C runs the walk once per chunk of G P channels and adds
//   the chunks' sums of each output in a warp's own shared memory.
// - Step m loads the three rows t0 - 3 + m, averages them in registers,
//   computes pair m, P_k = (s(u[2k - 5]), s(u[2k - 4])), k = t0 - 3 + m (as
//   aa_snake_bf16.cu: both from rows k - 5 .. k), and from step 5 on the
//   snake row r = t0 - 8 + m = sum_j kDown[2j] P_{r+j}.odd + kDown[2j+1]
//   P_{r+j}.even. The row goes into conv_post's pending sums: six slots
//   hold outputs r - 3 .. r + 2; row r finishes output r - 3 (tap 6) and
//   opens output r + 3 (tap 0) in the slot it frees. From step 11 on, each
//   step finishes one of the segment's outputs. Each s(u) is computed once:
//   2 an output plus 11 pairs a segment (5 before its first snake row, 6 for
//   conv_post's 3 + 3 halo rows).
// - Rows, pairs and pending sums live in six-slot register rings. The loop
//   body is six steps, so every slot index is a compile-time constant and
//   no register moves; a segment is a whole number of bodies. Each step
//   loads the rows of the same step of the next body into the registers it
//   has just averaged, so a group keeps six rows of three inputs in flight.
// - A body's six finished outputs are summed across the group's lanes by
//   xor shuffles, in a fixed order (deterministic, no atomics); lane J of
//   the group then takes output J, applies tanh and stores it (six
//   neighbouring bf16 a body).
//
// The sine is the hardware's (taps.cuh snake_bf16). Its error e_c <=
// (alpha_c max|u| 2^-21 + 2^-19) / beta_c per s(u) reaches the waveform
// through the down filter (sum |kDown| = 1.33) and conv_post as at most
// 1.33 sum_{j,c} |w[j, c]| max_c e_c (tanh' <= 1). That is far below the
// gate, 2^-8 x max|y|, less the store's half step, 2^-9 |y|: at
// chip_smoke.py's input scales the bound is 1e-5 to 2e-5 and the emulated
// error 3e-8 to 4e-8 against 1.2e-3 (tests/test_torch_epilogue_bf16.py).
// The average multiplies by 1/3, one rounding from the plain version's
// division.
//
// Edges follow taps.cuh: x rows clamp to [0, T - 1], u indices to
// [0, 2T - 1] (s(u[0]) / s(u[2T - 1]) stand in, computed only where a
// segment reaches an edge), snake rows outside [0, T) are conv_post's zero
// padding. The first 11 steps of a segment test every edge; the loop tests
// them only in a warp with a segment whose last row, t0 + seg + 7, reaches
// T (clamped loads, masked rows and stores), and the loop of every other
// warp runs a copy without the tests.
//
// The launch plan (seg, P, G, the grid, the shared memory) is
// ops/amp_triple.py:tail_bf16_plan; the entry point recomputes it and
// refuses a plan that disagrees or that it was not built for.
#include <cuda_runtime.h>

#include "taps.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kPeriod = 6;     // steps in the loop body: the rings' length
constexpr int kLead = 11;      // steps before a segment's first output
constexpr int kMaxSeg = 2040;  // outputs a group, a multiple of kPeriod
constexpr float kThird = 1.0f / 3.0f;

__device__ __forceinline__ unsigned short bf16_rn(float v) {
  unsigned short h;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(h) : "f"(v));
  return h;
}

template <int P>
struct Tail {
  const float* r[3];  // the block outputs at (b, 0, this lane's first channel)
  int T, C, G, t0;
  bool cok[P];
  float al[P], ib[P], s_lo[P], s_hi[P];
  float w[7][P];         // conv_post taps of this lane's channels
  float xs[kPeriod][P];  // the average at row t0 - 8 + i in slot i % 6
  float so[kPeriod][P];  // pair k = t0 - 3 + m in slot m % 6: s(u[2k - 5])
  float se[kPeriod][P];  //                                   s(u[2k - 4])
  float pend[kPeriod];   // conv_post sums of output o in slot (o - t0) % 6

  // The three inputs at row q (its element offset off = q C), this lane's
  // channels.
  __device__ __forceinline__ void load_off(size_t off, float (&v)[3][P]) const {
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < 3; ++i)
        v[i][p] = cok[p] ? __ldg(r[i] + off + p * G) : 0.f;
  }

  __device__ __forceinline__ void load(int q, bool clamp, float (&v)[3][P]) const {
    if (clamp) q = clampi(q, 0, T - 1);
    load_off((size_t)q * C, v);
  }

  template <int S>
  __device__ __forceinline__ void put(const float (&v)[3][P]) {
#pragma unroll
    for (int p = 0; p < P; ++p) xs[S][p] = (v[0][p] + v[1][p] + v[2][p]) * kThird;
  }

  // Pair m into slot M = m % 6 from the rows in slots M .. M + 5; with
  // kEdge, u indices outside [0, 2T - 1] take s_lo / s_hi.
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
        const int j = 2 * (t0 - 3 + m) - 5;  // u index of the odd member
        a = j < 0 ? s_lo[p] : (j > 2 * T - 1 ? s_hi[p] : a);
        e = j + 1 < 0 ? s_lo[p] : (j + 1 > 2 * T - 1 ? s_hi[p] : e);
      }
      so[M][p] = a;
      se[M][p] = e;
    }
  }

  // Step m (M = m % 6) after its row went into slot (m + 5) % 6: pair m,
  // then from step 5 on the snake row r = t0 - 8 + m into conv_post's
  // pending sums. Returns this lane's sum of output r - 3, finished by the
  // row (meaningful from step 11 on).
  template <int M, bool kEdge>
  __device__ __forceinline__ float step(int m) {
    pair_at<M, kEdge>(m);
    constexpr int M0 = (M + 1) % kPeriod;  // pairs r .. r + 5; slot of r - 3
    float a[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        acc += kDown[2 * j] * so[(M0 + j) % kPeriod][p];
        acc += kDown[2 * j + 1] * se[(M0 + j) % kPeriod][p];
      }
      a[p] = acc;
    }
    if (kEdge) {
      const int r = t0 - 8 + m;
      if (r < 0 || r >= T) {
#pragma unroll
        for (int p = 0; p < P; ++p) a[p] = 0.f;  // conv_post's zero padding
      }
    }
    // row r adds w[j] a to output r + 3 - j: tap 6 finishes r - 3, taps
    // 5 .. 1 go to r - 2 .. r + 2, tap 0 opens r + 3 in the freed slot
    float done = pend[M0];
#pragma unroll
    for (int p = 0; p < P; ++p) done = fmaf(w[6][p], a[p], done);
#pragma unroll
    for (int jj = 1; jj < 6; ++jj)
#pragma unroll
      for (int p = 0; p < P; ++p)
        pend[(M0 + jj) % kPeriod] =
            fmaf(w[6 - jj][p], a[p], pend[(M0 + jj) % kPeriod]);
    float open = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) open = fmaf(w[0][p], a[p], open);
    pend[M0] = open;
    return done;
  }

  // Steps 0 .. 10: rows t0 - 3 .. t0 + 7 (clamped), pairs t0 - 3 .. t0 + 7,
  // snake rows t0 - 3 .. t0 + 2 into the pending sums; no output finishes.
  template <int M>
  __device__ __forceinline__ void lead() {
    float v[3][P];
    load(t0 - 3 + M, true, v);
    put<(M + 5) % kPeriod>(v);
    if (M < 5)
      pair_at<M % kPeriod, true>(M);
    else
      step<M % kPeriod, true>(M);
  }
};

// At most kThreads threads, and registers for 5 (P = 1) or 3 (P = 2)
// blocks an SM: 20 or 12 warps, each with six rows of three inputs in
// flight. (6 blocks an SM, 80 registers, spilled more and measured slower
// at each bf16 launch shape's one-wave segment; 4 blocks, 128 registers,
// no faster: PERF.md.)
template <int P>
__global__ void __launch_bounds__(kThreads, P == 1 ? 5 : 3)
triple_post_bf16_kernel(const float* __restrict__ r0,
                        const float* __restrict__ r1,
                        const float* __restrict__ r2,
                        const float* __restrict__ alpha,
                        const float* __restrict__ inv_beta,
                        const float* __restrict__ w7,  // (7, C)
                        bf16* __restrict__ y, int B, int T, int C, int seg,
                        int G, int chunks, int segs) {
  extern __shared__ float chunk_sums[];  // chunks > 1: seg floats a warp
  const int lane = threadIdx.x & 31, gl = lane & (G - 1);
  const int warp = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const long long nseg = (long long)B * segs;
  long long sidx = (long long)warp * (32 / G) + lane / G;
  // a group past the last segment walks the last one and stores nothing,
  // so that every lane of a warp takes part in its shuffles
  if (__all_sync(0xffffffffu, sidx >= nseg)) return;
  const bool live = sidx < nseg;
  if (!live) sidx = nseg - 1;
  const int b = (int)(sidx / segs);
  const int t0 = (int)(sidx % segs) * seg;
  const bool end = __any_sync(0xffffffffu, t0 + seg + 7 >= T);
  float* sums = chunk_sums + (threadIdx.x >> 5) * seg;
  unsigned short* yb =
      reinterpret_cast<unsigned short*>(y) + (size_t)b * T + t0;
  const int bodies = seg / kPeriod;

  for (int k = 0; k < chunks; ++k) {
    Tail<P> s;
    s.T = T;
    s.C = C;
    s.G = G;
    s.t0 = t0;
    const int c0 = k * G * P + gl;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int c = c0 + p * G;
      s.cok[p] = c < C;
      s.al[p] = s.cok[p] ? __ldg(alpha + c) : 0.f;
      s.ib[p] = s.cok[p] ? __ldg(inv_beta + c) : 0.f;
#pragma unroll
      for (int j = 0; j < 7; ++j) s.w[j][p] = s.cok[p] ? __ldg(w7 + j * C + c) : 0.f;
      s.s_lo[p] = s.s_hi[p] = 0.f;
    }
    const size_t base = (size_t)b * T * C + c0;
    s.r[0] = r0 + base;
    s.r[1] = r1 + base;
    s.r[2] = r2 + base;
#pragma unroll
    for (int i = 0; i < kPeriod; ++i) s.pend[i] = 0.f;

    // the first body's rows, in flight through the lead
    float pf[kPeriod][3][P];
#pragma unroll
    for (int j = 0; j < kPeriod; ++j) s.load(t0 + 8 + j, end, pf[j]);
    // s(u[0]) and s(u[2T - 1]) where this segment's pairs reach an edge
    if (t0 < 3 || end) {
      float u0[P], u1[P];
#pragma unroll
      for (int p = 0; p < P; ++p) u0[p] = u1[p] = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        float v[3][P], q[3][P];
        s.load(i - 3, true, v);
        s.load(T - 3 + i, true, q);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          u0[p] += kUpEven[i] * ((v[0][p] + v[1][p] + v[2][p]) * kThird);
          u1[p] += kUpOdd[i] * ((q[0][p] + q[1][p] + q[2][p]) * kThird);
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        s.s_lo[p] = snake_bf16(u0[p], s.al[p], s.ib[p]);
        s.s_hi[p] = snake_bf16(u1[p], s.al[p], s.ib[p]);
      }
    }
    // rows t0 - 8 .. t0 - 4, then the lead's 11 steps
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      float v[3][P];
      s.load(t0 - 8 + i, true, v);
#pragma unroll
      for (int p = 0; p < P; ++p)
        s.xs[i][p] = (v[0][p] + v[1][p] + v[2][p]) * kThird;
    }
    s.template lead<0>();
    s.template lead<1>();
    s.template lead<2>();
    s.template lead<3>();
    s.template lead<4>();
    s.template lead<5>();
    s.template lead<6>();
    s.template lead<7>();
    s.template lead<8>();
    s.template lead<9>();
    s.template lead<10>();

    // Body n: steps 11 + 6n + J, J = 0 .. 5, finish outputs t0 + 6n + J.
    // Away from the end the next body's rows are addressed by an offset
    // advanced a row a step.
    size_t off = (size_t)(t0 + 8 + kPeriod) * C;
    for (int n = 0; n < bodies; ++n) {
      const bool more = n + 1 < bodies;
      float tot[kPeriod];
      if (end) {
#define TAIL_STEP(J)                                                       \
  s.template put<(J + 4) % kPeriod>(pf[J]);                                \
  if (more) s.load(t0 + 8 + kPeriod * (n + 1) + J, true, pf[J]);           \
  tot[J] = s.template step<(J + 5) % kPeriod, true>(kLead + kPeriod * n + J);
        TAIL_STEP(0) TAIL_STEP(1) TAIL_STEP(2) TAIL_STEP(3) TAIL_STEP(4)
        TAIL_STEP(5)
#undef TAIL_STEP
      } else {
#define TAIL_STEP(J)                                                       \
  s.template put<(J + 4) % kPeriod>(pf[J]);                                \
  if (more) s.load_off(off, pf[J]);                                        \
  off += C;                                                                \
  tot[J] = s.template step<(J + 5) % kPeriod, false>(kLead + kPeriod * n + J);
        TAIL_STEP(0) TAIL_STEP(1) TAIL_STEP(2) TAIL_STEP(3) TAIL_STEP(4)
        TAIL_STEP(5)
#undef TAIL_STEP
      }
      // the group's sums, six independent butterflies
      for (int o = G >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int J = 0; J < kPeriod; ++J)
          tot[J] += __shfl_xor_sync(0xffffffffu, tot[J], o);
      }
      // lane J of the group takes output J (G < 6: lanes take several)
      for (int J = gl; J < kPeriod; J += G) {
        float v = tot[0];
#pragma unroll
        for (int i = 1; i < kPeriod; ++i) v = J == i ? tot[i] : v;
        const int o = kPeriod * n + J;  // output t0 + o
        if (chunks > 1) {  // G = 32: one segment a warp, lane J's own sums
          if (k > 0) v += sums[o];
          if (k + 1 < chunks) {
            sums[o] = v;
            continue;
          }
        }
        if (live && (!end || t0 + o < T)) yb[o] = bf16_rn(tanhf(v));
      }
    }
  }
}

template <int P>
int launch(const float* r0, const float* r1, const float* r2,
           const float* alpha, const float* inv_beta, const float* w7,
           void* y, int B, int T, int C, int seg, int G, int chunks,
           int segs, int blocks, int smem_bytes, cudaStream_t stream) {
  triple_post_bf16_kernel<P><<<blocks, kThreads, smem_bytes, stream>>>(
      r0, r1, r2, alpha, inv_beta, w7, static_cast<bf16*>(y), B, T, C, seg,
      G, chunks, segs);
  return (int)cudaGetLastError();
}

}  // namespace

// seg: outputs a group, a multiple of 6 up to 384; pack: channels a lane,
// 1 at C <= 32, else 2; blocks and smem_bytes must be that plan's,
// ceil(ceil(B ceil(T / seg) / (32 / G)) / 4) blocks and, at more than one
// channel chunk, 4 x seg floats of shared memory (else 0), with G = 32 at
// C > 16, else the power of two >= C, and chunks = ceil(C / (G pack)).
extern "C" int triple_post_bf16_fwd(const float* r0, const float* r1,
                                    const float* r2, const float* alpha,
                                    const float* inv_beta, const float* w7,
                                    void* y, int B, int T, int C, int seg,
                                    int pack, int blocks, int smem_bytes,
                                    void* stream) {
  if (B < 1 || T < 1 || C < 1 || seg < kPeriod || seg > kMaxSeg ||
      seg % kPeriod)
    return (int)cudaErrorInvalidValue;
  if (pack != (C > 32 ? 2 : 1)) return (int)cudaErrorInvalidValue;
  int G = 1;
  while (G < C && G < 32) G *= 2;
  const int chunks = (C + G * pack - 1) / (G * pack);
  const int segs = (T + seg - 1) / seg;
  const long long warps = ((long long)B * segs + 32 / G - 1) / (32 / G);
  const long long want = (warps + kThreads / 32 - 1) / (kThreads / 32);
  const int smem = chunks > 1 ? (kThreads / 32) * seg * 4 : 0;
  if (blocks != want || smem_bytes != smem || warps > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (pack == 2)
    return launch<2>(r0, r1, r2, alpha, inv_beta, w7, y, B, T, C, seg, G,
                     chunks, segs, blocks, smem_bytes, s);
  return launch<1>(r0, r1, r2, alpha, inv_beta, w7, y, B, T, C, seg, G,
                   chunks, segs, blocks, smem_bytes, s);
}

