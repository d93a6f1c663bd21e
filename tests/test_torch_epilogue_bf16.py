"""The bf16 tail kernel's plan and algorithm on the CPU
(csrc/triple_post_bf16.cu; the kernel itself runs only on a card, where
tests/test_torch_cuda.py and chip_smoke.py hold it to composed_epilogue):

- the constants of `amp_triple.tail_bf16_plan` equal the CUDA source's,
  and the entry point's checks are the plan's;
- under the plan's grid every output (b, t) is stored by exactly one lane,
  every channel is read by exactly one (chunk, lane, slot), and only a warp
  that runs the loop's edge copy stores past T, at the bf16 launch shapes
  chip_smoke.py names and at ragged ones; a plan the kernel does not take
  is refused;
- `kernel_tail` takes the kernel's indices (not its arithmetic): which x
  rows a segment loads, clamped only where the kernel clamps, which u index
  each pair stands for and where s(u[0]) / s(u[2T - 1]) stand in, which
  snake rows are conv_post's zero padding, and which outputs a segment
  finishes; with the snake left out (u itself), the outputs must equal the
  plain down2(up2(x)) under conv_post at T = 1 .. 2 seg + 10 and at T that
  are no multiple of the segment (atol 1e-5, rtol 1e-4: float32 sums in
  another order);
- the hardware sine's error, carried through the down filter and conv_post
  in float64, stays under the bf16 gate less the store's half step, and
  under the bound the source states;
- on the CPU `fused_epilogue(..., out_dtype=bf16)` is `composed_epilogue`
  rounded once.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_epilogue_bf16.py -q
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from megatts2_hierspeechpp_torch.nn.conv import conv1d_op
from megatts2_hierspeechpp_torch.ops import amp_triple
from megatts2_hierspeechpp_torch.ops.resample import (
    activation1d, downsample1d, upsample1d)

CSRC = Path(amp_triple.__file__).parents[1] / "csrc"
SRC = (CSRC / "triple_post_bf16.cu").read_text()
TAPS = (CSRC / "taps.cuh").read_text()
# (B, T, C) of the bf16 tail's launches: bench.py's SpeechSR-48k and
# Generator tails (B = 4 x 1000 frames), the vocoder CLI's eval and training
# step (B = 32), and the B = 1 serving shapes of 500 frames
SHAPES = [(4, 960000, 32), (4, 320000, 16), (32, 61440, 16), (32, 10240, 16),
          (1, 160000, 16), (1, 480000, 32)]
RAGGED = [(2, 1, 1), (2, 7, 7), (2, 1000, 16), (3, 13, 33), (2, 50, 64),
          (2, 97, 100), (1, 400, 200)]
BF16_MARGIN = 2.0 ** -8


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Several worker processes run the suite at once: cap torch's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _taps(name):
    body = re.search(rf"{name}\[\d+\] = \{{([^}}]*)\}}", TAPS).group(1)
    return np.array([float(v.strip().rstrip("f")) for v in body.split(",")],
                    np.float32)


UP_EVEN, UP_ODD, DOWN = _taps("kUpEven"), _taps("kUpOdd"), _taps("kDown")


def test_constants_match_the_cuda_source():
    assert _int("kThreads") == amp_triple.TAIL_BF16_THREADS
    assert _int("kPeriod") == amp_triple.TAIL_BF16_PERIOD
    assert _int("kLead") == amp_triple.TAIL_BF16_LEAD
    assert _int("kMaxSeg") == amp_triple.TAIL_BF16_MAX_SEG
    assert amp_triple.TAIL_BF16_MAX_SEG % amp_triple.TAIL_BF16_PERIOD == 0
    # the plan's residency is the kernel's launch bounds
    occ = amp_triple.TAIL_BF16_BLOCKS_PER_SM
    assert (f"__launch_bounds__(kThreads, P == 1 ? {occ[1]} : {occ[2]})"
            in SRC)
    # the entry point recomputes the plan: lanes, packing, chunks, grid and
    # shared memory
    for line in ("if (pack != (C > 32 ? 2 : 1)) return (int)cudaErrorInvalidValue;",
                 "while (G < C && G < 32) G *= 2;",
                 "const int chunks = (C + G * pack - 1) / (G * pack);",
                 "((long long)B * segs + 32 / G - 1) / (32 / G);",
                 "(warps + kThreads / 32 - 1) / (kThreads / 32);",
                 "chunks > 1 ? (kThreads / 32) * seg * 4 : 0;",
                 "if (blocks != want || smem_bytes != smem"):
        assert line in SRC, line
    # the lead: 5 pairs before the first snake row, then conv_post's 6 halo
    # rows; a warp takes the loop's edge copy where a segment's last row
    # t0 + seg + 7 reaches T
    assert amp_triple.TAIL_BF16_LEAD == 5 + 6
    assert "__any_sync(0xffffffffu, t0 + seg + 7 >= T)" in SRC


def _owners(b, t, c, plan):
    """Times each output (b, t) is stored and each channel read under
    `plan`, lane by lane as the kernel maps them; and whether a warp without
    the edge copy would store at t >= T."""
    lanes, pack, chunks = plan["lanes"], plan["pack"], plan["chunks"]
    seg, segs = plan["seg"], plan["segs"]
    groups = 32 // lanes
    nseg = b * segs
    warp = np.arange(plan["blocks"] * amp_triple.TAIL_BF16_THREADS // 32)
    lane = np.arange(32)
    sidx = warp[:, None] * groups + lane[None] // lanes
    active = (sidx < nseg).any(axis=1)[:, None]       # whole warps exit
    live = sidx < nseg
    s = np.minimum(sidx, nseg - 1)
    bb, t0 = s // segs, (s % segs) * seg
    end = (t0 + seg + 7 >= t).any(axis=1)[:, None]    # the warp's copy
    gl = lane[None] & (lanes - 1)
    count = np.zeros((b, segs * seg), np.int64)
    unmasked_past_t = False
    for j in range(amp_triple.TAIL_BF16_PERIOD):
        store = active & live & (j % lanes == gl)     # lane gl takes J = gl mod G
        for n in range(seg // amp_triple.TAIL_BF16_PERIOD):
            tt = t0 + 6 * n + j
            unmasked_past_t |= bool((store & ~end & (tt >= t)).any())
            keep = store & (~end | (tt < t))
            np.add.at(count, (np.broadcast_to(bb, keep.shape)[keep],
                              np.broadcast_to(tt, keep.shape)[keep]), 1)
    reads = np.zeros(chunks * lanes * pack, np.int64)
    for k in range(chunks):
        for g in range(lanes):
            for p in range(pack):
                reads[k * lanes * pack + g + p * lanes] += 1
    return count, reads, unmasked_past_t


@pytest.mark.parametrize("shape", SHAPES + RAGGED)
def test_plan_owns_every_output_once(shape):
    b, t, c = shape
    short = (6,) if b * t < 10 ** 5 else ()   # keeps the large shapes' arrays small
    for seg in short + (24, 48, 96, 384, amp_triple.TAIL_BF16_MAX_SEG, None):
        plan = amp_triple.tail_bf16_plan(b, t, c, seg)
        assert plan["pack"] == (2 if c > 32 else 1)
        assert plan["lanes"] == min(32, 1 << (c - 1).bit_length())
        assert plan["lanes"] * plan["pack"] * plan["chunks"] >= c
        count, reads, unmasked = _owners(b, t, c, plan)
        assert (count[:, :t] == 1).all()
        assert (count[:, t:] == 0).all()
        assert not unmasked
        assert (reads[:c] == 1).all()
        # more than one chunk only with one segment a warp (32 lanes): the
        # chunks' sums sit in the warp's own seg floats
        if plan["chunks"] > 1:
            assert plan["lanes"] == 32
            assert plan["smem"] == 4 * 4 * plan["seg"]
        else:
            assert plan["smem"] == 0
        warps = -(-b * plan["segs"] // (32 // plan["lanes"]))
        assert plan["warps"] == warps and plan["blocks"] == -(-warps // 4)


@pytest.mark.parametrize("shape,seg", [
    ((4, 960000, 32), 1458), ((4, 320000, 16), 246), ((32, 61440, 16), 378),
    ((32, 10240, 16), 66), ((1, 160000, 16), 36), ((1, 480000, 32), 186),
    ((2, 7, 7), 6), ((64, 960000, 32), 2040)])
def test_default_segment_is_one_resident_wave(shape, seg):
    """The shortest segment with which every group is resident at once on
    an H100 (132 SMs, TAIL_BF16_BLOCKS_PER_SM blocks each), at most
    TAIL_BF16_MAX_SEG."""
    plan = amp_triple.tail_bf16_plan(*shape)
    assert plan["seg"] == seg
    if seg < amp_triple.TAIL_BF16_MAX_SEG:
        assert plan["waves"] <= 1
        if seg > amp_triple.TAIL_BF16_PERIOD:
            shorter = amp_triple.tail_bf16_plan(*shape, seg=seg - 6)
            assert shorter["waves"] > 1
    else:
        assert plan["waves"] > 1
    # another card's SM count moves the segment with it
    assert amp_triple.tail_bf16_plan(*shape, sms=66)["seg"] >= seg


def test_refuses_plans_it_does_not_know():
    for seg in (0, 25, 2046):
        with pytest.raises(ValueError, match=f"seg={seg}"):
            amp_triple.tail_bf16_plan(1, 100, 16, seg=seg)
    with pytest.raises(ValueError, match="C=0"):
        amp_triple.tail_bf16_plan(1, 100, 0)
    with pytest.raises(ValueError, match="T=0"):
        amp_triple.tail_bf16_plan(1, 0, 16)
    # the entry point refuses a segment it was not built for
    assert "seg < kPeriod || seg > kMaxSeg ||\n      seg % kPeriod)" in SRC
    rs = [torch.zeros(1, 10, 8) for _ in range(3)]
    post = (torch.ones(8), torch.ones(8), torch.zeros(7, 8))
    # the wrappers' plan arguments, refused before any launch
    with pytest.raises(ValueError, match="seg"):
        amp_triple._epilogue(*rs, post, tile=248, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="seg"):
        amp_triple._epilogue(*rs, post, seg=24)


def kernel_tail(x, w, seg, t0, end):
    """The outputs segment t0 of csrc/triple_post_bf16.cu finishes, by
    index, with the snake left out (s(u) = u): {o: y[:, o] before tanh}.
    Step m = 0 .. seg + 10 loads x row k = t0 - 3 + m (rows t0 - 8 ..
    t0 - 4 before the first step) and computes pair k: u[2k - 5] (odd taps)
    and u[2k - 4] (even taps), both from rows k - 5 .. k. From step 5 on it
    forms snake row r = t0 - 8 + m from pairs r .. r + 5, from step 11 on
    it finishes output r - 3 from rows r - 6 .. r. The first 11 steps clamp
    rows, take s(u[0]) / s(u[2T - 1]) (here u[0] / u[2T - 1]) outside [0,
    2T - 1] and zero rows outside [0, T); the loop does so only in a warp
    that takes the edge copy (end); an unchecked row, u index or output
    outside its range fails, as does an edge value a segment did not
    compute (t0 < 3 or end)."""
    b, t, c = x.shape
    lead = amp_triple.TAIL_BF16_LEAD

    def load(q, checked):
        if checked:
            q = min(max(q, 0), t - 1)
        assert 0 <= q < t, f"unclamped load of row {q}, T={t}"
        return x[:, q]

    def up(taps, qs):
        return sum(taps[i] * x[:, min(max(q, 0), t - 1)] for i, q in enumerate(qs))

    edge = {}
    if t0 < 3 or end:
        edge["lo"] = up(UP_EVEN, range(-3, 3))
        edge["hi"] = up(UP_ODD, range(t - 3, t + 3))
    rows = {t0 - 8 + i: load(t0 - 8 + i, True) for i in range(5)}
    u, a, out = {}, {}, {}
    for m in range(seg + lead):
        checked = m < lead or end
        k = t0 - 3 + m
        rows[k] = load(k, checked)
        xs = [rows[k - 5 + i] for i in range(6)]
        for j, taps in ((2 * k - 5, UP_ODD), (2 * k - 4, UP_EVEN)):
            if 0 <= j <= 2 * t - 1:
                u[j] = sum(taps[i] * xs[i] for i in range(6))
                continue
            assert checked, f"unchecked loop reaches u[{j}], T={t}"
            side = "lo" if j < 0 else "hi"
            assert side in edge, f"segment {t0} takes s_{side} unset, T={t}"
            u[j] = edge[side]
        if m < 5:
            continue
        r = t0 - 8 + m
        if 0 <= r < t:
            a[r] = sum(DOWN[i] * u[2 * r - 5 + i] for i in range(12))
        else:
            assert checked, f"unchecked snake row {r}, T={t}"
            a[r] = np.zeros((b, c), np.float32)
        if m < lead:
            continue
        o = r - 3
        if o >= t:
            assert end, f"unmasked output {o}, T={t}"
            continue
        out[o] = sum(a[o - 3 + j] @ w[j] for j in range(7))
    return out


@pytest.mark.parametrize("seg,lengths", [
    (24, list(range(1, 59)) + [59, 60, 61, 73, 100]),
    (48, [1, 5, 47, 48, 49, 55, 56, 57, 106, 107, 150])])
def test_emulation_matches_the_plain_version(seg, lengths):
    """Every output, from the one segment that finishes it (kernel_tail),
    equals the plain conv_post(down2(up2(x))) at its index, whether the
    segment's warp runs the loop's edge copy or, away from the end, not."""
    rng = np.random.default_rng(seg)
    b, c = 2, 3
    for t in lengths:
        x = rng.standard_normal((b, t, c)).astype(np.float32)
        w = rng.standard_normal((7, c)).astype(np.float32)
        a_ref = activation1d(torch.from_numpy(x), lambda v: v)
        y_ref = conv1d_op(a_ref, torch.from_numpy(w).t().unsqueeze(0), None,
                          1, 3, 1)[..., 0].numpy()
        seen = np.zeros(t, np.int64)
        for t0 in range(0, t, seg):
            end = t0 + seg + 7 >= t
            for e in {end, True}:  # the edge copy is right for any segment
                out = kernel_tail(x, w, seg, t0, e)
                assert sorted(out) == list(range(t0, min(t0 + seg, t)))
                for o, v in out.items():
                    np.testing.assert_allclose(
                        v, y_ref[:, o], atol=1e-5, rtol=1e-4,
                        err_msg=f"T={t} seg={seg} t0={t0} end={e} y[{o}]")
            seen[t0: t0 + seg] += 1
        assert (seen == 1).all()


def _hw_sin(v):
    """The hardware sine as taps.cuh's snake_bf16 takes it: v / (2 pi) as
    one float32 multiply rounded toward zero, the sine of its fraction (in
    float64; the unit's own error, about 2^-21.4, is added by the caller)."""
    rev = np.float32(1 / (2 * math.pi))
    exact = v.astype(np.float64) * np.float64(rev)
    turns = exact.astype(np.float32)
    away = np.abs(turns.astype(np.float64)) > np.abs(exact)
    turns[away] = np.nextafter(turns[away], np.float32(0))
    frac = turns.astype(np.float64) - np.rint(turns.astype(np.float64))
    return np.sin(2 * math.pi * frac)


def _tail64(avg, alpha, inv_beta, w, sin):
    """tanh(conv_post(AA-snake(avg))) in float64 with `sin` for the snake's
    sine (its argument alpha u as the kernel's float32 product); and u."""
    uu = upsample1d(torch.from_numpy(avg.astype(np.float64))).numpy()
    v = (uu.astype(np.float32) * alpha.astype(np.float32)).astype(np.float32)
    s = uu + sin(v) ** 2 * inv_beta
    a = downsample1d(torch.from_numpy(s)).numpy()
    y = conv1d_op(torch.from_numpy(a), torch.from_numpy(w.astype(np.float64)).t()
                  .unsqueeze(0), None, 1, 3, 1).numpy()
    return np.tanh(y), uu


@pytest.mark.parametrize("c,alpha_scale", [(16, 1.0), (32, 1.0), (32, 10.0)])
def test_hardware_sine_error_through_the_tail_fits_the_bf16_gate(c, alpha_scale):
    """The tail with the hardware sine against the exact sine, both in
    float64 otherwise, at chip_smoke.py's input scales (block outputs 3 x
    N(0, 1), alpha and beta exp(0.2 N(0, 1)), conv_post 0.1 (7C)^-1/2 N(0, 1);
    alpha also 10 x): the difference, plus the unit's own 2^-21.4 carried
    through sin^2 (2 x), the down filter (sum |kDown| = 1.33) and conv_post
    (sum |w|), stays under the source's bound, 1.33 sum|w| max_c (alpha_c
    max|u| 2^-21 + 2^-19) / beta_c, and that under the gate less the
    store's half step, 2^-9 x max|y|."""
    rng = np.random.default_rng(c)
    t = 4096
    rs = [rng.standard_normal((1, t, c)) * 3.0 for _ in range(3)]
    avg = ((rs[0] + rs[1] + rs[2]) / 3.0).astype(np.float32)
    alpha = np.exp(0.2 * rng.standard_normal(c)) * alpha_scale
    inv_beta = 1.0 / np.exp(0.2 * rng.standard_normal(c))
    w = rng.standard_normal((7, c)) * 0.1 * (7 * c) ** -0.5
    y_hw, u = _tail64(avg, alpha, inv_beta, w, _hw_sin)
    y_ex, _ = _tail64(avg, alpha, inv_beta, w, np.sin)
    down = float(np.abs(DOWN.astype(np.float64)).sum())
    assert abs(down - 1.33) < 0.01
    w_abs = float(np.abs(w).sum())
    unit = down * w_abs * float(inv_beta.max()) * 2 * 2.0 ** -21.4
    err = float(np.abs(y_hw - y_ex).max()) + unit
    bound = down * w_abs * float(np.max(
        (alpha * np.abs(u).max() * 2.0 ** -21 + 2.0 ** -19) * inv_beta))
    gate = 2.0 ** -9 * float(np.abs(y_ex).max())
    assert err <= bound <= gate, (err, bound, gate)


@pytest.mark.parametrize("shape", [(1, 256, 16), (2, 300, 32), (2, 7, 7)])
def test_cpu_wrapper_is_the_plain_version_rounded_once(shape):
    rng = np.random.default_rng(11)
    b, t, c = shape
    rs = [torch.from_numpy((rng.standard_normal(shape) * 3).astype(np.float32))
          for _ in range(3)]
    post = (torch.from_numpy(np.exp(0.2 * rng.standard_normal(c)).astype(np.float32)),
            torch.from_numpy(np.exp(0.2 * rng.standard_normal(c)).astype(np.float32)),
            torch.from_numpy((rng.standard_normal((7, c)) * 0.1).astype(np.float32)))
    got = amp_triple.fused_epilogue(*rs, post, torch.bfloat16)
    want = amp_triple.composed_epilogue(*rs, post)
    assert got.dtype == torch.bfloat16 and got.shape == (b, t, 1)
    assert torch.equal(got, want.to(torch.bfloat16))
    # within half a bf16 step of the float32 tail
    assert (got.float() - want).abs().max() <= BF16_MARGIN * want.abs().max()
