// Monotonic alignment search: a native C++/OpenMP kernel for the host.
//
// The port's own copy of the JAX package's native/mas.cpp (the reference's
// only native component is its Cython/OpenMP MAS kernel, monotonic_align/
// core.pyx). The DP: value[y][x] += max(value[y-1][x], value[y-1][x-1]),
// backtraced from (t_y-1, t_x-1). Batch-parallel via OpenMP.
//
// Build (ops/mas_native.py does it on first use):
//   g++ -O3 -fopenmp -shared -fPIC mas.cpp -o libmas.so
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>

extern "C" {

// paths: (B, T_y, T_x) int32 out; values: (B, T_y, T_x) float32 (mutated);
// t_ys/t_xs: (B,) int32 valid lengths.
void maximum_path_batch(int32_t* paths, float* values, const int32_t* t_ys,
                        const int32_t* t_xs, int32_t b, int32_t max_t_y,
                        int32_t max_t_x) {
  constexpr float kNegInf = -1e9f;
#pragma omp parallel for schedule(dynamic)
  for (int32_t i = 0; i < b; ++i) {
    const int32_t t_y = t_ys[i];
    const int32_t t_x = t_xs[i];
    float* v = values + static_cast<int64_t>(i) * max_t_y * max_t_x;
    int32_t* p = paths + static_cast<int64_t>(i) * max_t_y * max_t_x;

    // forward DP
    for (int32_t y = 0; y < t_y; ++y) {
      const int32_t x_lo = std::max(0, t_x + y - t_y);
      const int32_t x_hi = std::min(t_x, y + 1);
      float* row = v + static_cast<int64_t>(y) * max_t_x;
      const float* prev = row - max_t_x;
      for (int32_t x = x_lo; x < x_hi; ++x) {
        float v_cur = (x == y) ? kNegInf : (y > 0 ? prev[x] : 0.0f);
        float v_diag = (x == 0) ? (y == 0 ? 0.0f : kNegInf)
                                : (y > 0 ? prev[x - 1] : kNegInf);
        if (y == 0 && x == 0) {
          v_cur = 0.0f;
          v_diag = 0.0f;
        }
        row[x] += std::max(v_cur, v_diag);
      }
    }

    // backtrace
    int32_t x = t_x - 1;
    for (int32_t y = t_y - 1; y >= 0; --y) {
      p[static_cast<int64_t>(y) * max_t_x + x] = 1;
      if (y > 0 && x > 0) {
        const float* prev = v + static_cast<int64_t>(y - 1) * max_t_x;
        if (x == y || prev[x] < prev[x - 1]) {
          --x;
        }
      }
    }
  }
}

}  // extern "C"
