"""Monotonic alignment search in the port (ops/monotonic_align.py in torch,
ops/mas_native.py with the port's own native/mas.cpp) against the JAX
package's ops/monotonic_align.py on the CPU: ragged lengths per row, the
three paths exactly equal; on planted ties the port's two paths and the
JAX package's native kernel equal (the reference kernel's tie rule), the
JAX scan at the same total; the path valid (one x per frame, steps of 0 or
1, from (0, 0) to (t_y - 1, t_x - 1)) and its score the brute-force
optimum; nothing outside each row's valid region; the native build in the
port's build directory and its length checks."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from megatts2_hierspeechpp_torch.ops import mas_native
from megatts2_hierspeechpp_torch.ops.cuda_lib import BUILD_DIR
from megatts2_hierspeechpp_torch.ops.monotonic_align import maximum_path
from megatts2_hierspeechpp_tpu.ops import mas_native as jax_native
from megatts2_hierspeechpp_tpu.ops.monotonic_align import maximum_path as mas_jax


def brute_force_best_score(value, t_y, t_x):
    neg = -1e9
    dp = np.full((t_y, t_x), neg)
    dp[0, 0] = value[0, 0]
    for y in range(1, t_y):
        for x in range(min(y + 1, t_x)):
            best = dp[y - 1, x] if x < y else neg
            if x > 0:
                best = max(best, dp[y - 1, x - 1])
            if best > neg / 2:
                dp[y, x] = best + value[y, x]
    return dp[t_y - 1, t_x - 1]


def ragged(seed, b, t_y, t_x):
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((b, t_y, t_x)).astype(np.float32)
    t_ys = rng.integers(t_y // 2, t_y + 1, b).astype(np.int32)
    t_ys[0] = t_y
    t_xs = np.minimum(rng.integers(2, t_x + 1, b), t_ys).astype(np.int32)
    t_xs[0] = t_x
    return value, t_ys, t_xs


@pytest.mark.parametrize("shape", [(3, 14, 6), (8, 50, 12), (4, 40, 40)])
def test_torch_native_and_jax_paths_equal(shape):
    value, t_ys, t_xs = ragged(sum(shape), *shape)
    got = maximum_path(*map(torch.from_numpy, (value, t_ys, t_xs)))
    assert got.dtype == torch.float32 and got.shape == shape
    got = got.numpy()
    want = np.asarray(mas_jax(*map(jnp.asarray, (value, t_ys, t_xs))))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mas_native.maximum_path(value, t_ys, t_xs),
                                  got.astype(np.int32))
    for i, (ty, tx) in enumerate(zip(t_ys, t_xs)):
        p = got[i, :ty, :tx]
        assert (p.sum(1) == 1).all()
        xs = p.argmax(1)
        assert xs[0] == 0 and xs[-1] == tx - 1 and set(np.diff(xs)) <= {0, 1}
        np.testing.assert_allclose(value[i][np.arange(ty), xs].sum(),
                                   brute_force_best_score(value[i], ty, tx),
                                   rtol=1e-5)
        assert got[i].sum() == ty   # nothing outside the valid region


@pytest.mark.parametrize("scores", ["zeros", "small_integers"])
def test_ties_broken_as_the_reference_kernel(scores):
    """Planted equal scores: the backtrace moves diagonally only when that
    is strictly better (the reference's Cython rule), in the torch path and
    in both native copies alike; the JAX scan, which takes the diagonal on
    a tie, reaches the same total."""
    b, t_y, t_x = 4, 30, 9
    rng = np.random.default_rng(5)
    value = (np.zeros((b, t_y, t_x), np.float32) if scores == "zeros" else
             rng.integers(-1, 2, (b, t_y, t_x)).astype(np.float32))
    t_ys = np.array([30, 24, 17, 12], np.int32)
    t_xs = np.array([9, 5, 9, 3], np.int32)
    got = maximum_path(*map(torch.from_numpy, (value, t_ys, t_xs))).numpy()
    want = mas_native.maximum_path(value, t_ys, t_xs)
    np.testing.assert_array_equal(got.astype(np.int32), want)
    np.testing.assert_array_equal(jax_native.maximum_path(value, t_ys, t_xs),
                                  want)
    jax_path = np.asarray(mas_jax(*map(jnp.asarray, (value, t_ys, t_xs))))
    for i, (ty, tx) in enumerate(zip(t_ys, t_xs)):
        xs = got[i, :ty, :tx].argmax(1)
        assert xs[0] == 0 and xs[-1] == tx - 1 and set(np.diff(xs)) <= {0, 1}
        best = brute_force_best_score(value[i], ty, tx)
        assert value[i][np.arange(ty), xs].sum() == best
        assert (value[i] * jax_path[i]).sum() == best
    if scores == "zeros":   # every path ties: stay at the last x until forced
        for i, (ty, tx) in enumerate(zip(t_ys, t_xs)):
            xs = got[i, :ty, :tx].argmax(1)
            np.testing.assert_array_equal(
                xs, np.minimum(np.arange(ty), tx - 1))


def test_native_builds_into_the_port_build_dir_and_checks_lengths():
    value, t_ys, t_xs = ragged(1, 2, 10, 4)
    before = value.copy()
    mas_native.maximum_path(value, t_ys, t_xs)
    np.testing.assert_array_equal(value, before)   # the input is not written
    assert list(BUILD_DIR.glob("libmas-*.so"))
    with pytest.raises(ValueError, match="lengths"):
        mas_native.maximum_path(value, np.array([10, 3], np.int32),
                                np.array([4, 4], np.int32))
    with pytest.raises(ValueError, match="B = 2"):
        mas_native.maximum_path(value, t_ys[:1], t_xs[:1])
