// Shared pieces of the anti-aliased SnakeBeta kernels.
//
// Filter taps of the x2 kaiser-sinc resampler (ops/resample.py,
// kaiser_sinc_filter1d(0.25, 0.3, 12)), as float32 literals. They equal
// ops/snake.py:_polyphase_taps(); tests/test_torch_kernels.py checks it.
//
//   u[2p]   = sum_i kUpEven[i] * x[clamp(p - 3 + i)]     i = 0..5
//   u[2p+1] = sum_i kUpOdd[i]  * x[clamp(p - 2 + i)]     i = 0..5
//   y[t]    = sum_k kDown[k]   * s(u[clamp(2t + k - 5)]) k = 0..11
//
// x indices clamp to [0, T-1] and u indices to [0, 2T-1]: that is the
// replicate padding the composed op applies before each resampler, so the
// kernels match it at the sequence edges too.
#pragma once

static __constant__ float kUpEven[6] = {
    4.057933111e-03f, -5.108692870e-02f, 2.571452260e-01f,
    8.864195943e-01f, -1.153147519e-01f, 1.877892762e-02f};
static __constant__ float kUpOdd[6] = {
    1.877892762e-02f, -1.153147519e-01f, 8.864195943e-01f,
    2.571452260e-01f, -5.108692870e-02f, 4.057933111e-03f};
static __constant__ float kDown[12] = {
    2.028966555e-03f, 9.389463812e-03f, -2.554346435e-02f,
    -5.765737593e-02f, 1.285726130e-01f, 4.432097971e-01f,
    4.432097971e-01f, 1.285726130e-01f, -5.765737593e-02f,
    -2.554346435e-02f, 9.389463812e-03f, 2.028966555e-03f};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Activations in device memory are float32 or bf16 (the TPU kernels' bf16
// configuration: bf16 in and out, float32 inside). A bf16 value is held as
// its 16 bits, the high half of a float32; the kernels load it as float32
// and round a float32 result to it on store.
struct bf16 {
  unsigned short bits;
};

// float32 -> bf16 bits, round to nearest even (as torch's .to(bfloat16))
__device__ __forceinline__ unsigned short bf16_bits(float f) {
  const unsigned u = __float_as_uint(f);
  return static_cast<unsigned short>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

__device__ __forceinline__ float ld_act(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_act(const bf16* p) {
  return __uint_as_float(
      static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))
      << 16);
}
__device__ __forceinline__ void st_act(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_act(bf16* p, float v) { p->bits = bf16_bits(v); }

// Stages of one channel chunk of an anti-aliased snake over the output
// window [w0, w0 + n). Shared-memory rows are [row][kChunk], one channel per
// lane, so a warp reads and writes 32 consecutive floats.
//
//   xs: (n + 12) rows, x at clamp(w0 - 6 + r)
//   us: (2n + 10) rows, s(u) at clamp(2 w0 - 5 + r)
//
// stage_x fills xs, stage_u fills us from xs, down_at(r) returns the output
// at w0 + r from us. up_at and snake give one s(u) from xs, for kernels that
// keep the 12 down-filter inputs in registers instead of in us.
constexpr int kChunk = 32;

__device__ __forceinline__ void stage_x(float* xs, const float* xb, int w0,
                                        int n, int T, int C, int c, bool cok,
                                        int row0, int row_step) {
  for (int r = row0; r < n + 12; r += row_step) {
    const int p = clampi(w0 - 6 + r, 0, T - 1);
    xs[r * kChunk + (threadIdx.x & 31)] = cok ? xb[(size_t)p * C + c] : 0.f;
  }
}

// u[clamp(j)] of the x2 upsampler, from an xs staged by stage_x at w0.
__device__ __forceinline__ float up_at(const float* xs, int w0, int T, int j) {
  const int lane = threadIdx.x & 31;
  j = clampi(j, 0, 2 * T - 1);
  const int base = (j >> 1) - (w0 - 6);  // row of x[j / 2] in xs
  float u = 0.f;
  if (j & 1) {
#pragma unroll
    for (int i = 0; i < 6; ++i) u += kUpOdd[i] * xs[(base - 2 + i) * kChunk + lane];
  } else {
#pragma unroll
    for (int i = 0; i < 6; ++i) u += kUpEven[i] * xs[(base - 3 + i) * kChunk + lane];
  }
  return u;
}

// SnakeBeta, u + sin(alpha u)^2 / beta. sinf, not __sinf: its accuracy is
// part of the kernels' error budget.
__device__ __forceinline__ float snake(float u, float alpha, float inv_beta) {
  const float s = sinf(u * alpha);
  return u + s * s * inv_beta;
}

// SnakeBeta in the bf16 configuration (aa_snake_bf16.cu,
// triple_post_bf16.cu) with the hardware sine (__sinf): one multiply by
// 1 / (2 pi) reduces v = alpha u to revolutions, which the hardware sine
// takes modulo 1. Its absolute error is about 2^-21.4 plus |v| 2^-23 (the
// rounding of v / (2 pi)), so sin^2 / beta errs by under
// (|v| 2^-21 + 2^-19) / beta (tests/test_torch_snake_bf16.py).
__device__ __forceinline__ float snake_bf16(float u, float alpha,
                                            float inv_beta) {
  const float s = __sinf(u * alpha);
  return u + s * s * inv_beta;
}

__device__ __forceinline__ void stage_u(float* us, const float* xs, int w0,
                                        int n, int T, float alpha,
                                        float inv_beta, int row0,
                                        int row_step) {
  const int lane = threadIdx.x & 31;
  for (int r = row0; r < 2 * n + 10; r += row_step)
    us[r * kChunk + lane] = snake(up_at(xs, w0, T, 2 * w0 - 5 + r), alpha, inv_beta);
}

__device__ __forceinline__ float down_at(const float* us, int r) {
  const int lane = threadIdx.x & 31;
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < 12; ++k) v += kDown[k] * us[(2 * r + k) * kChunk + lane];
  return v;
}

// Register-window form, for kernels that give each thread one channel and
// R consecutive outputs p0..p0+R-1 (aa_snake.cu, triple_epilogue.cu).
// xw[i] = x[clamp(p0 - 5 + i)], i = 0..R+9, holds every x those outputs
// read; the s(u) at u = 2 p0 - 5 + j, j = 0..2R+9, are each computed once
// and feed the down filter straight from registers. Where that u index
// leaves [0, 2T-1] it clamps: s_lo = s(u[0]) and s_hi = s(u[2T-1]) stand in
// there, which the caller computes (su_at) only where its outputs reach an
// edge (p0 < 3, p0 + R > T - 3). The sums run in the order of up_at and
// down_at. (A copy without the clamp test for the threads away from the
// edges measured slower: two unrolled copies of the loop.)

template <int R>
__device__ __forceinline__ void aa_window(const float (&xw)[R + 10], int p0,
                                          int T, float s_lo, float s_hi,
                                          float alpha, float inv_beta,
                                          float (&y)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) y[r] = 0.f;
#pragma unroll
  for (int j = 0; j < 2 * R + 10; ++j) {
    float u = 0.f;
    if (j & 1) {  // u index even
#pragma unroll
      for (int i = 0; i < 6; ++i) u += kUpEven[i] * xw[(j - 1) / 2 + i];
    } else {
#pragma unroll
      for (int i = 0; i < 6; ++i) u += kUpOdd[i] * xw[j / 2 + i];
    }
    const int uj = 2 * p0 - 5 + j;
    float s = snake(u, alpha, inv_beta);
    s = uj < 0 ? s_lo : (uj > 2 * T - 1 ? s_hi : s);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = j - 2 * r;
      if (k >= 0 && k < 12) y[r] += kDown[k] * s;
    }
  }
}

// s(u[j]) for 0 <= j < 2T, x(q) returning x at row q, 0 <= q < T.
template <class X>
__device__ __forceinline__ float su_at(X x, int j, int T, float alpha,
                                       float inv_beta) {
  const int m = j >> 1;
  float u = 0.f;
  if (j & 1) {
#pragma unroll
    for (int i = 0; i < 6; ++i) u += kUpOdd[i] * x(clampi(m - 2 + i, 0, T - 1));
  } else {
#pragma unroll
    for (int i = 0; i < 6; ++i) u += kUpEven[i] * x(clampi(m - 3 + i, 0, T - 1));
  }
  return snake(u, alpha, inv_beta);
}
