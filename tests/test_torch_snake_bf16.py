"""The bf16 AA-snake kernel's plan and algorithm on the CPU
(csrc/aa_snake_bf16.cu; the kernel itself runs only on a card, where
tests/test_torch_cuda.py and chip_smoke.py hold it to its bf16 twin):

- the constants of `snake.snake_bf16_plan` equal the CUDA source's, and
  an emulation of the hardware sine's reduction stays inside the bf16
  gate;
- under the plan's grid every output (b, t, c) has exactly one owning
  thread, at every bf16 launch shape chip_smoke.py names (serving, bench,
  eval and training) and at ragged ones; a plan the kernel does not take is
  refused;
- `kernel_u` takes the kernel's indices (not its arithmetic): which u index
  each of a segment's pairs stands for, from which x rows, clamped only
  where the kernel clamps, and where it takes the edge values s(u[0]) /
  s(u[2T - 1]) instead, only in a segment that computed them; with the
  snake left out (u itself), those u and the 12-tap down window over them
  must equal the plain upsampler and downsampler at T = 1 .. seg + 10 and
  at T that are no multiple of the segment (atol 1e-5, rtol 1e-4: float32
  sums in another order than the composed convolutions). The kernel's
  arithmetic is held to its twin on the card (tests/test_torch_cuda.py
  test_snakebeta_bf16_every_plan, T = 1 .. 768 at every segment).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_snake_bf16.py -q
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from megatts2_hierspeechpp_torch.ops import snake
from megatts2_hierspeechpp_torch.ops.resample import activation1d, upsample1d

SRC = (Path(snake.__file__).parents[1] / "csrc" / "aa_snake_bf16.cu").read_text()
TAPS = (Path(snake.__file__).parents[1] / "csrc" / "taps.cuh").read_text()
# (B, T, C) of the bf16 launches: serving (one 500-frame request's 4T rows),
# bench.py's B = 4 x 1000 frames, the vocoder CLI's eval (B = 32) and its
# training step (B = 32, 32-frame windows)
SHAPES = [(1, 2000, 256), (1, 2000, 64), (4, 4000, 256), (4, 4000, 64),
          (32, 768, 256), (32, 768, 64), (32, 128, 192), (32, 128, 256),
          (32, 128, 64)]


def _int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _taps(name):
    body = re.search(rf"{name}\[\d+\] = \{{([^}}]*)\}}", TAPS).group(1)
    return np.array([float(v.strip().rstrip("f")) for v in body.split(",")],
                    np.float32)


UP_EVEN, UP_ODD, DOWN = _taps("kUpEven"), _taps("kUpOdd"), _taps("kDown")


def test_constants_match_the_cuda_source():
    assert _int("kThreads") == snake.BF16_THREADS
    assert _int("kPeriod") == snake.BF16_PERIOD
    assert _int("kMaxSeg") == snake.BF16_MAX_SEG
    for seg in snake.BF16_SEGS:
        assert seg % snake.BF16_PERIOD == 0 and seg <= snake.BF16_MAX_SEG
    # the entry point's grid: ceil(B * ceil(T / seg) * chunks / 4)
    assert "(warps + kThreads / 32 - 1) / (kThreads / 32)" in SRC
    assert "(C + 32 * pack - 1) / (32 * pack)" in SRC


def test_hardware_sine_error_fits_the_bf16_gate():
    """__sinf reduces v to revolutions with one float32 multiply by
    1 / (2 pi) rounded toward zero, and takes the sine of the fraction
    (its own error about 2^-21.4). Emulated in float64, |sin^2 - sin^2|
    stays under |v| 2^-21 + 2^-19 for |v| = |alpha u| up to 10^4: times
    1 / beta, far below the bf16 gate, 2^-8 x max|ref| (about 2^-8 |u| at
    least), at any alpha / beta a trained snake reaches."""
    v = np.linspace(-1e4, 1e4, 2_000_001).astype(np.float32)
    rev = np.float32(1 / (2 * math.pi))
    turns = (v.astype(np.float64) * np.float64(rev)).astype(np.float32)
    # round toward zero: step back where the float32 cast rounded away
    away = np.abs(turns.astype(np.float64)) > np.abs(v.astype(np.float64) * np.float64(rev))
    turns[away] = np.nextafter(turns[away], np.float32(0))
    frac = turns.astype(np.float64) - np.rint(turns.astype(np.float64))
    hw = np.sin(2 * math.pi * frac)
    err = np.abs(hw ** 2 - np.sin(v.astype(np.float64)) ** 2) + 2 * 2.0 ** -21.4
    assert (err <= np.abs(v.astype(np.float64)) * 2.0 ** -21 + 2.0 ** -19).all()


def _owners(b, t, c, plan):
    """Times each output (b, t, c) is written under `plan`, thread by
    thread as the kernel maps them (its warp mapping and its t < T)."""
    seg, pack, chunks, segs = (plan[k] for k in ("seg", "pack", "chunks", "segs"))
    warp = np.arange(plan["blocks"] * snake.BF16_THREADS // 32)
    lane = np.arange(32)
    chunk, rest = (warp % chunks)[:, None], (warp // chunks)[:, None]
    bb, sg = rest // segs, rest % segs
    c0 = (chunk * 32 + lane[None]) * pack
    live = (bb < b) & (c0 < c)
    count = np.zeros((b, segs * seg, c), np.int64)
    for p in range(pack):
        for r in range(seg):
            np.add.at(count, (np.broadcast_to(bb, live.shape)[live],
                              np.broadcast_to(sg * seg + r, live.shape)[live],
                              c0[live] + p), 1)
    return count[:, :t], count[:, t:]


@pytest.mark.parametrize("shape", SHAPES + [(2, 1, 7), (2, 7, 200), (1, 37, 16),
                                            (3, 13, 65), (2, 50, 64)])
def test_plan_owns_every_output_once(shape):
    b, t, c = shape
    for seg in snake.BF16_SEGS + (None,):
        for align in (16, 4, 2):
            plan = snake.snake_bf16_plan(b, t, c, seg, align)
            assert plan["pack"] == (2 if c % 2 == 0 and align >= 4 else 1)
            owned, beyond = _owners(b, t, c, plan)
            assert (owned == 1).all()
            assert (beyond == 1).all()   # computed, never stored (t < T)
            warps = b * plan["segs"] * plan["chunks"]
            assert plan["blocks"] == -(-warps // 4)


@pytest.mark.parametrize("shape,seg", [
    ((1, 2000, 256), 12), ((1, 2000, 64), 12), ((4, 4000, 256), 48),
    ((4, 4000, 64), 12), ((32, 768, 256), 48), ((32, 768, 64), 24),
    ((32, 128, 192), 12), ((32, 128, 256), 18), ((32, 128, 64), 12)])
def test_default_segment_by_occupancy(shape, seg):
    """The longest segment that still gives BF16_WARPS warps, else the
    shortest."""
    plan = snake.snake_bf16_plan(*shape)
    assert plan["seg"] == seg
    longer = [s for s in snake.BF16_SEGS if s > seg]
    assert all(snake.snake_bf16_plan(*shape, seg=s)["warps"] < snake.BF16_WARPS
               for s in longer)


def test_refuses_plans_it_does_not_know():
    with pytest.raises(ValueError, match="seg=13"):
        snake.snake_bf16_plan(1, 100, 64, seg=13)
    with pytest.raises(ValueError, match="seg=6"):
        snake.snake_bf16_plan(1, 100, 64, seg=6)
    # the entry point refuses a packing it was not built for, or whose rows
    # the channels or the alignment do not allow
    assert "if (pack != 1 && pack != 2) return (int)cudaErrorInvalidValue;" in SRC
    assert "if (C % pack || reinterpret_cast<size_t>(x) % align ||" in SRC
    x = torch.zeros(1, 10, 8, dtype=torch.bfloat16)
    a = torch.ones(8)
    # the wrappers' plan arguments, refused before any launch
    with pytest.raises(ValueError, match="rows"):
        snake._launch(x, a, a, rows=8)
    with pytest.raises(ValueError, match="seg=30"):
        snake._launch(x, a, a, seg=30)
    with pytest.raises(ValueError, match="seg"):
        snake._launch(x.float(), a, a, seg=12)


def kernel_u(x, seg, t0):
    """The u values segment t0 of csrc/aa_snake_bf16.cu computes, by u
    index (the snake left out). Pair m = 0 .. seg + 4 of the segment, k =
    t0 + m, stands for u[2k - 5] (odd taps) and u[2k - 4] (even taps), both
    from x rows k - 5 .. k. Rows before t0 + 5 come from the prologue,
    clamped to [0, T - 1]; later rows from the loop, clamped only in a
    segment that reaches past T - 1 (end), and an unclamped row outside
    [0, T) fails. A u index below 0 takes s(u[0]) and one above 2T - 1
    s(u[2T - 1]) (here u[0] and u[2T - 1]), only where the kernel tests
    for them (the prologue's pairs and an end segment's loop) and only in
    a segment that computed them (t0 < 3 or end)."""
    b, t, c = x.shape
    end = t0 + seg + 4 >= t

    def up(taps, q):
        return np.einsum("i,bic->bc", taps, x[:, q])

    edge = {}
    if t0 < 3 or end:
        edge["lo"] = up(UP_EVEN, np.clip(np.arange(-3, 3), 0, t - 1))
        edge["hi"] = up(UP_ODD, np.clip(np.arange(t - 3, t + 3), 0, t - 1))
    u = {}
    for m in range(seg + 5):
        k = t0 + m
        q = np.arange(k - 5, k + 1)
        q = np.where((q < t0 + 5) | end, np.clip(q, 0, t - 1), q)
        assert ((0 <= q) & (q < t)).all(), f"unclamped load of rows {q}, T={t}"
        for j, taps in ((2 * k - 5, UP_ODD), (2 * k - 4, UP_EVEN)):
            if 0 <= j <= 2 * t - 1:
                u[j] = up(taps, q)
                continue
            assert m < 5 or end, f"unchecked loop reaches u[{j}], T={t}"
            side = "lo" if j < 0 else "hi"
            assert side in edge, f"segment {t0} takes s_{side} unset, T={t}"
            u[j] = edge[side]
    return u


@pytest.mark.parametrize("seg,lengths", [
    (12, list(range(1, 23)) + [23, 37, 50, 61]),
    (24, [1, 2, 5, 29, 30, 34, 35, 49, 71]),
    (48, [1, 3, 53, 58, 100])])
def test_emulation_matches_the_plain_version(seg, lengths):
    """Every segment's u (kernel_u) equals the plain upsampler's at the
    clamped index, and each output's down window over them, y[t] =
    sum_i kDown[i] u[2t - 5 + i] (emit's order: kDown[2j] on the odd
    member of pair t + j, kDown[2j + 1] on the even one), equals the plain
    down2(up2(x))."""
    rng = np.random.default_rng(seg)
    c = 5
    for t in lengths:
        x = rng.standard_normal((2, t, c)).astype(np.float32)
        u_ref = upsample1d(torch.from_numpy(x)).numpy()
        y_ref = activation1d(torch.from_numpy(x), lambda v: v).numpy()
        for t0 in range(0, t, seg):
            u = kernel_u(x, seg, t0)
            for j, v in u.items():
                np.testing.assert_allclose(
                    v, u_ref[:, min(max(j, 0), 2 * t - 1)], atol=1e-5,
                    rtol=1e-4, err_msg=f"T={t} seg={seg} t0={t0} u[{j}]")
            for tt in range(t0, min(t0 + seg, t)):
                y = sum(DOWN[i] * u[2 * tt - 5 + i] for i in range(12))
                np.testing.assert_allclose(
                    y, y_ref[:, tt], atol=1e-5, rtol=1e-4,
                    err_msg=f"T={t} seg={seg} y[{tt}]")
