"""The port's CUDA kernels against their plain versions, on a card. Skips
without one. Imports only torch and the port, so it runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: atol 1e-5, rtol 1e-4 for the snake and the triple's average;
1e-4 for the triple's tail (sin, tanh, 7 C-term sums) and the conv kernels
(accumulation order over k*C terms; the split-TF32 products are as accurate
as float32, a single TF32 pass would fail it, see test_torch_tf32split.py).
The vocoder kernels' bf16 configuration: the AA-snake and one snake_conv
launch within 2^-8 x max|ref| of the bf16 twin's float32 value before its
last rounding (half a bf16 step; against the rounded twin a single rounding
flip in the top binade is a full step); a snake_conv launch that writes
float32 also within 1e-4 x mean|ref| in mean |error| at T >= 127 (its
operand flips are rare; a bf16-rounded output reads about 1.4e-3); the
AMPBlock and the triple, chains of rounded convs, no farther from the
float32 plain version than twice the twin is (see _chain_close). The PLM decode kernel's codes must pass
the teacher-forced check (each code within 1e-4 x max|logits| of its row's
max logit), since one near-tie flip changes every later step; its bf16
configurations the same check against the bf16 plain twin (plain_gap)
within one bf16 step, 2^-8 x max|logits| (the twin on the CPU and on the
card, whose sums differ only in order, already differ by several 1e-4 x
max|logits| at T = 500: a value within float error of a bf16 rounding
boundary rounds either way).

The vc front end and the denoiser at full width, card against the same
weights on the CPU (library convs, matmuls and attention; no kernel of
ours): Wav2Vec2 features atol 1e-4 x max|ref|; YIN voicing on 99 % of
frames and f0 within 1e-4 relative where both voice; MPNet's magnitude
within 1e-4 x max|ref| and its phase within 1e-3 on the circle where the
spectrum is not near zero, on one STFT fed to both (the first frame's
phases are +-pi by the FFT's rounding, see tests/test_torch_denoiser.py);
the query-chunked attention equal to the dense form within 1e-5 x
max|ref|; `vc` with the f0 and the denoiser's STFT given, 48 kHz waveform
before normalisation within 1e-3, as chip_smoke.py's card-vs-CPU gate.

Training on the card: one SpeechSR step (the stage kernel forward and
backward) against the CPU, losses 1e-4 relative and gradients 1e-3
relative L2, chip_smoke.py's gates; MPNet's training build with remat on
and off (loss 1e-6 relative, running statistics 1e-6 x max) and chunked
attention (loss 1e-5 relative)."""
import numpy as np
import pytest
import torch

from megatts2_hierspeechpp_torch.infer import pipeline as tpipe
from megatts2_hierspeechpp_torch.models import plm
from megatts2_hierspeechpp_torch.models.denoiser import MPNet
from megatts2_hierspeechpp_torch.models.speechsr import SpeechSR
from megatts2_hierspeechpp_torch.models.vocoder import HierVocoder
from megatts2_hierspeechpp_torch.models.wav2vec2 import Wav2Vec2
from megatts2_hierspeechpp_torch.nn.conv import conv1d_op
from megatts2_hierspeechpp_torch.ops import amp_triple, ampblock, cuda_lib, snake
from megatts2_hierspeechpp_torch.ops.f0 import yin_f0
from megatts2_hierspeechpp_torch.ops.plm_decode import (
    MAX_ROWS, plain_decode, plain_gap, plm_decode_greedy)
from megatts2_hierspeechpp_torch.ops.resample import activation1d
from megatts2_hierspeechpp_torch.ops.stft import mag_pha_stft

DIL = (1, 3, 5)
BF16_MARGIN = 2.0 ** -8  # the bf16 decode's teacher-forced gap, x max|logits|
EXACT_RATIO = 2.0        # a bf16 chain's distance from float32 over its twin's
MMA_F32_MEAN_TOL = 1e-4  # a float32-output bf16 launch: mean |err| / mean |ref|
CHANNELS = (7, 8, 16, 32, 48, 64, 128)  # 7: the 4-byte copy path, ragged tiles
KERNEL_SIZES = (3, 5, 7, 11)
# T = 1, 7, both sides of a time tile edge (snake_conv's tiles are 32, 64 or
# 128 samples; at B = 2 and T near 128 it takes 32-sample tiles, near 8448 on
# a 132-SM card the 128-sample ones), and 4097
LENGTHS = (1, 7, 127, 128, 129, 4097, 8447, 8448, 8449)
# segments of the bf16 tail's walk (multiples of 6 up to its 2040) beside
# its plan's own
TAIL_BF16_SEGS = (6, 24, 48, 96, 384, 2040)


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, dev, *shape, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)


def _block_ws(rng, dev, k, c):
    pos = lambda: torch.exp(_rand(rng, dev, 3, c, scale=0.2))
    w = lambda: _rand(rng, dev, 3, k, c, c, scale=(c * k) ** -0.5)
    b = lambda: _rand(rng, dev, 3, c, scale=0.05)
    return (pos(), pos(), w(), b(), pos(), pos(), w(), b())


def _plain_snake_conv(x, a, ib, w, bias, d, res=None, rounded=False):
    """conv_d(snake(x)) + bias (+ res); `rounded`: the snake's output
    rounded to bf16 (the bf16 products; the caller rounds w)."""
    y = activation1d(x, lambda v: v + torch.sin(v * a).square() * ib)
    if rounded:
        y = ampblock.rounded(y)
    y = conv1d_op(y, w.permute(1, 2, 0), bias, 1, (w.shape[0] - 1) // 2 * d, d)
    return y if res is None else y + res


@pytest.mark.cuda
@pytest.mark.parametrize("k", KERNEL_SIZES)
@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("t", LENGTHS)
def test_kernels_match_plain(dev, t, c, k):
    """Every T >= 1 runs the kernels (no short-T fallback), at every width
    the port takes: snake_conv alone at d = 1, 3, 5 (with the residual at
    d = 1), the AMPBlock, and the triple with and without the tail. Each
    wrapper call counts once; snake_conv alone is not counted."""
    rng = np.random.default_rng(1000 * t + 10 * c + k)
    x = _rand(rng, dev, 2, t, c)
    a, be = torch.exp(_rand(rng, dev, c, scale=0.3)), torch.exp(_rand(rng, dev, c, scale=0.3))
    ws = _block_ws(rng, dev, k, c)
    post = (torch.exp(_rand(rng, dev, c, scale=0.2)),
            torch.exp(_rand(rng, dev, c, scale=0.2)),
            _rand(rng, dev, 7, c, scale=0.1 * (7 * c) ** -0.5))
    res = _rand(rng, dev, 2, t, c)
    cuda_lib.reset_launches()
    with torch.inference_mode():
        torch.testing.assert_close(snake.fused_aa_snakebeta(x, a, be),
                                   snake.composed_snakebeta(x, a, be),
                                   atol=1e-5, rtol=1e-4)
        for i, d in enumerate(DIL):
            r = res if d == 1 else None
            args = (x, ws[0][i], ws[1][i], ws[2][i], ws[3][i], d)
            torch.testing.assert_close(ampblock.snake_conv(*args, res=r),
                                       _plain_snake_conv(*args, res=r),
                                       atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(ampblock.fused_ampblock(x, *ws, k, DIL),
                                   ampblock.composed_ampblock(x, *ws, k, DIL),
                                   atol=1e-4, rtol=1e-4)
        for p in (None, post):
            torch.testing.assert_close(
                amp_triple.fused_amp_triple(x, [ws] * 3, (k,) * 3, (DIL,) * 3, p),
                amp_triple.composed_triple(x, [ws] * 3, (k,) * 3, (DIL,) * 3, p),
                atol=1e-4, rtol=1e-4)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES == dict.fromkeys(cuda_lib.LAUNCHES, 0) | {
        "aa_snakebeta": 1, "ampblock": 1, "amp_triple": 2}


def _close_bf16(got, want32):
    """A bf16 kernel output against its plain version's float32 value
    before the final rounding: within 2^-8 x max|ref| (a correctly rounded
    bf16 value is within half a step of it; the float32 sums differ in
    order)."""
    assert got.dtype == torch.bfloat16
    err = (got.float() - want32).abs().max().item()
    scale = want32.abs().max().item()
    assert err <= BF16_MARGIN * scale, (err, scale)


def _chain_close(got, twin32, f32):
    """A chain of rounded convs (an AMPBlock, a stage) in bf16: its distance
    from the float32 plain version at most EXACT_RATIO x the bf16 twin's.
    Kernel and twin round the same operands, but a value within float error
    of a bf16 boundary rounds either way and the chain carries the flip on:
    against the twin the kernel reaches 1.04-1.10 x 2^-8 x max|ref| in 5 of
    these 252 shapes."""
    assert got.dtype == torch.bfloat16
    d_kernel = (got.float() - f32).abs().max().item()
    d_twin = (twin32.bfloat16().float() - f32).abs().max().item()
    assert d_kernel <= EXACT_RATIO * d_twin, (d_kernel, d_twin)


@pytest.mark.cuda
@pytest.mark.parametrize("k", KERNEL_SIZES)
@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("t", LENGTHS)
def test_kernels_match_plain_bf16(dev, t, c, k):
    """The bf16 configuration at every shape of the float32 test: bf16 x,
    float32 inside, bf16 out, each conv one bf16 product pass with float32
    sums. The AA-snake and snake_conv alone (with each I/O type the blocks
    use: bf16 x in, float32 out; float32 x with a bf16 residual, bf16 out)
    against their bf16 twins before the final rounding; the AMPBlock and
    the triple with and without the tail by their distance from float32
    (_chain_close). Each wrapper call counts under its `_bf16` key."""
    rng = np.random.default_rng(1000 * t + 10 * c + k + 1)
    x = _rand(rng, dev, 2, t, c).bfloat16()
    a, be = torch.exp(_rand(rng, dev, c, scale=0.3)), torch.exp(_rand(rng, dev, c, scale=0.3))
    ws = _block_ws(rng, dev, k, c)
    post = (torch.exp(_rand(rng, dev, c, scale=0.2)),
            torch.exp(_rand(rng, dev, c, scale=0.2)),
            _rand(rng, dev, 7, c, scale=0.1 * (7 * c) ** -0.5))
    res = _rand(rng, dev, 2, t, c).bfloat16()
    x32 = x.float()
    cuda_lib.reset_launches()
    with torch.inference_mode():
        _close_bf16(snake.fused_aa_snakebeta(x, a, be),
                    snake.composed_snakebeta(x32, a, be))
        for i, d in enumerate(DIL):
            args = (ws[0][i], ws[1][i], ws[2][i], ws[3][i], d)
            w32 = ampblock.rounded(args[2])
            want = _plain_snake_conv(x32, *args[:2], w32, *args[3:],
                                     rounded=True)
            got = ampblock.snake_conv(x, *args, bf16_mma=True)
            assert got.dtype == torch.float32
            assert (got - want).abs().max() <= BF16_MARGIN * want.abs().max()
            if t >= 127:  # enough outputs that one operand flip averages out
                mean_err = ((got - want).abs().mean() / want.abs().mean()).item()
                assert mean_err <= MMA_F32_MEAN_TOL, mean_err
            want = _plain_snake_conv(x32, *args[:2], w32, *args[3:],
                                     res=res.float(), rounded=True)
            _close_bf16(ampblock.snake_conv(x32, *args, res=res, bf16_mma=True,
                                            out_dtype=torch.bfloat16), want)
        _chain_close(ampblock.fused_ampblock(x, *ws, k, DIL),
                     ampblock.block_math(x32, *ws, k, DIL, bf16_products=True),
                     ampblock.block_math(x32, *ws, k, DIL))
        for p in (None, post):
            stage = (x32, [ws] * 3, (k,) * 3, (DIL,) * 3, p)
            _chain_close(
                amp_triple.fused_amp_triple(x, *stage[1:]),
                amp_triple.triple_math(*stage, bf16_products=True),
                amp_triple.triple_math(*stage))
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES == dict.fromkeys(cuda_lib.LAUNCHES, 0) | {
        "aa_snakebeta_bf16": 1, "ampblock_bf16": 1, "amp_triple_bf16": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 200, 512])
@pytest.mark.parametrize("t", [1, 7, 8, 2000, 2001])
def test_snakebeta_wide_channels(dev, t, c):
    """The AA-snake at the serving path's C = 256, a ragged 200 and 512,
    with every rows-per-thread the kernel is built for, and on a view whose
    start is not 16-byte aligned; each call counts one launch."""
    rng = np.random.default_rng(7 * t + c)
    x = _rand(rng, dev, 2, t, c)
    a, be = torch.exp(_rand(rng, dev, c, scale=0.3)), torch.exp(_rand(rng, dev, c, scale=0.3))
    cuda_lib.reset_launches()
    with torch.inference_mode():
        want = snake.composed_snakebeta(x, a, be)
        torch.testing.assert_close(snake.fused_aa_snakebeta(x, a, be), want,
                                   atol=1e-5, rtol=1e-4)
        for rows in snake.ROWS:
            torch.testing.assert_close(snake._launch(x, a, be, rows=rows), want,
                                       atol=1e-5, rtol=1e-4)
        xv = torch.empty(2 * t * c + 1, device=dev)[1:].view(2, t, c).copy_(x)
        torch.testing.assert_close(snake.fused_aa_snakebeta(xv, a, be), want,
                                   atol=1e-5, rtol=1e-4)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["aa_snakebeta"] == 2 + len(snake.ROWS)


@pytest.mark.cuda
@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("c", [7, 16, 32, 48, 64])
@pytest.mark.parametrize("t", [1, 7, 23, 24, 25, 119, 120, 121, 247, 248,
                               249, 1000])
def test_epilogue_matches_plain(dev, t, c, tail):
    """csrc/triple_epilogue.cu alone on given block outputs, B = 2, against
    composed_epilogue: T = 1, 7, both sides of the plan's 248-sample tile
    and of two shorter tiles the kernel takes at wider C, and a T that is a
    multiple of none; C = 7 takes the 4-byte copies; the tail at
    every tile. Average to 1e-5, the tail to 1e-4 (sin, tanh and the conv's
    7 C-term sums)."""
    rng = np.random.default_rng(100 * t + c + tail)
    rs = [_rand(rng, dev, 2, t, c, scale=3.0) for _ in range(3)]
    post = (torch.exp(_rand(rng, dev, c, scale=0.2)),
            torch.exp(_rand(rng, dev, c, scale=0.2)),
            _rand(rng, dev, 7, c, scale=0.1 * (7 * c) ** -0.5)) if tail else None
    tol = 1e-4 if tail else 1e-5
    with torch.inference_mode():
        want = amp_triple.composed_epilogue(*rs, post)
        got = amp_triple.fused_epilogue(*rs, post)
        torch.testing.assert_close(got, want, atol=tol, rtol=1e-4)
        if tail:  # every tile that fits
            for tile in amp_triple.EPILOGUE_TILES:
                if amp_triple.epilogue_smem(c, tile) <= amp_triple.SMEM_LIMIT:
                    torch.testing.assert_close(
                        amp_triple._epilogue(*rs, post, tile), want,
                        atol=tol, rtol=1e-4)
        # misaligned views take the 4-byte copies
        views = [torch.empty(r.numel() + 1, device=dev)[1:].view_as(r).copy_(r)
                 for r in rs]
        torch.testing.assert_close(amp_triple.fused_epilogue(*views, post), got,
                                   atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 7, 16, 32, 33, 64, 100, 200])
@pytest.mark.parametrize("t", [1, 2, 5, 12, 13, 23, 24, 25, 35, 47, 48, 60,
                               97, 200, 401, 1000])
def test_epilogue_bf16_every_plan(dev, t, c):
    """The bf16 tail, csrc/triple_post_bf16.cu, B = 2, at its plan's
    segment, at TAIL_BF16_SEGS (the shortest, the longest and between)
    and on views 4 bytes off a 16-byte boundary, against
    composed_epilogue within 2^-8 x max|ref| (bf16_check's single
    rounding); T = 1 .. 1000 on both sides of the segments and of their
    11-step lead; C = 1 / 7 / 16 (groups of 1 / 8 / 16 lanes), 32, 33 / 64
    (two channels a lane), 100 / 200 (2 and 4 channel chunks). Two launches
    give the same bits; the bf16 average (triple_epilogue.cu) beside it."""
    rng = np.random.default_rng(7 * t + c)
    rs = [_rand(rng, dev, 2, t, c, scale=3.0) for _ in range(3)]
    post = (torch.exp(_rand(rng, dev, c, scale=0.2)),
            torch.exp(_rand(rng, dev, c, scale=0.2)),
            _rand(rng, dev, 7, c, scale=0.1 * (7 * c) ** -0.5))
    bf = torch.bfloat16
    views = [torch.empty(r.numel() + 1, device=dev)[1:].view_as(r).copy_(r)
             for r in rs]
    calls = [lambda s=s: amp_triple._epilogue(*rs, post, out_dtype=bf, seg=s)
             for s in TAIL_BF16_SEGS]
    calls.append(lambda: amp_triple.fused_epilogue(*views, post, bf))
    with torch.inference_mode():
        want = amp_triple.composed_epilogue(*rs, post)
        for fn in calls:
            got = fn()
            assert got.shape == (2, t, 1)
            _close_bf16(got, want)
        assert torch.equal(calls[-1](), calls[-1]())
        _close_bf16(amp_triple.fused_epilogue(*rs, out_dtype=bf),
                    amp_triple.composed_epilogue(*rs))


@pytest.mark.cuda
def test_epilogue_and_snake_are_deterministic(dev):
    """Two identical launches give bit-identical output: no atomics, every
    sum in a fixed order."""
    rng = np.random.default_rng(9)
    t, c = 160_000, 16
    rs = [_rand(rng, dev, 1, t, c) for _ in range(3)]
    post = (torch.exp(_rand(rng, dev, c, scale=0.2)),
            torch.exp(_rand(rng, dev, c, scale=0.2)),
            _rand(rng, dev, 7, c, scale=0.1 * (7 * c) ** -0.5))
    x = _rand(rng, dev, 1, 2000, 256)
    a, be = torch.exp(_rand(rng, dev, 256, scale=0.3)), torch.exp(_rand(rng, dev, 256, scale=0.3))
    with torch.inference_mode():
        for fn in (lambda: amp_triple.fused_epilogue(*rs, post),
                   lambda: amp_triple.fused_epilogue(*rs),
                   lambda: snake.fused_aa_snakebeta(x, a, be)):
            assert torch.equal(fn(), fn())


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 37, 300, 500, 1100])
def test_plm_decode_kernel_matches_plain(dev, t):
    """The persistent decode kernel at full width (d = 276, 4 layers, 1024
    bins) in float32 (named: the wrapper's default is the bf16 serving
    configuration): one launch, codes that pass the teacher-forced check,
    mostly the plain greedy decode's codes. At T = 1100 the keys outgrow 32
    splits of 32, so a split holds more than one 32-key chunk."""
    model = plm.ProsodyLM(seed=3, device="cuda")
    rng = np.random.default_rng(t)
    tc = _rand(rng, dev, 1, t, 256)
    w = model.packed()
    f32 = torch.float32
    cuda_lib.reset_launches()
    with torch.inference_mode():
        got = plm_decode_greedy(w, tc, model.go_id, f32, f32)
        torch.cuda.synchronize()
        assert cuda_lib.LAUNCHES["plm_decode"] == 1
        want = plain_decode(w, tc, model.go_id)
        assert torch.equal(plm.decode(model, tc, weight_dtype=f32,
                                      cache_dtype=f32), got)
    assert cuda_lib.LAUNCHES["plm_decode"] == 2
    assert got.shape == (1, t) and got.dtype == torch.int32
    gap, scale = plm.teacher_forced_gap(model, tc, got)
    assert gap <= 1e-4 * scale
    assert (got == want).float().mean() >= 0.5


@pytest.mark.cuda
def test_plm_decode_kernel_is_deterministic(dev):
    """Ten launches on the same inputs give the same codes: no float
    atomics, fixed-order sums, and no handoff that reads a stale value (a
    stale epoch or a missing fence would show as a rare flip)."""
    model = plm.ProsodyLM(seed=4, device="cuda")
    tc = _rand(np.random.default_rng(500), dev, 1, 500, 256)
    w = model.packed()
    f32 = torch.float32
    with torch.inference_mode():
        first = plm_decode_greedy(w, tc, model.go_id, f32, f32)
        for _ in range(9):
            assert torch.equal(plm_decode_greedy(w, tc, model.go_id, f32, f32),
                               first)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 37, 500, 1100])
@pytest.mark.parametrize("wdt,cdt", [("bf16", "bf16"), ("bf16", "f32"),
                                     ("f32", "bf16")])
def test_plm_decode_bf16_kernel_matches_its_plain_twin(dev, t, wdt, cdt):
    """The bf16 configurations (weights, KV cache or both in bf16): one
    launch, counted under its source (plm_decode_bf16 for bf16 weights and
    cache, plm_decode for a mixed pair), codes that pass the teacher-forced
    check against the plain twin in the same dtypes (gap <= 2^-8 x
    max|logits|, see the module docstring), two launches identical."""
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    wd, cd = dt[wdt], dt[cdt]
    both = wdt == cdt == "bf16"
    model = plm.ProsodyLM(seed=5, device="cuda")
    tc = _rand(np.random.default_rng(t + 7), dev, 1, t, 256)
    w = model.packed()
    cuda_lib.reset_launches()
    with torch.inference_mode():
        got = plm_decode_greedy(w, tc, model.go_id, wd, cd)
        torch.cuda.synchronize()
        assert cuda_lib.LAUNCHES == dict(cuda_lib.LAUNCHES,
                                         plm_decode=int(not both),
                                         plm_decode_bf16=int(both))
        assert torch.equal(plm_decode_greedy(w, tc, model.go_id, wd, cd), got)
        gap, scale = plain_gap(w, tc, got, model.go_id, wd, cd)
    assert got.shape == (1, t) and got.dtype == torch.int32
    assert gap <= BF16_MARGIN * scale, (gap, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plm_decode_per_row_batch(dev, dtype):
    """A greedy batch of 4 rows: float32 one kernel launch a row, bf16 one
    launch of all 4 (ceil(B / MAX_ROWS)), never the plain loop; each row's
    codes are its own single-row decode's, and pass the teacher-forced
    check against plain_decode's batch."""
    model = plm.ProsodyLM(seed=6, device="cuda")
    tc = _rand(np.random.default_rng(11), dev, 4, 120, 256)
    key = "plm_decode" if dtype == torch.float32 else "plm_decode_bf16"
    cuda_lib.reset_launches()
    with torch.inference_mode():
        got = plm.decode(model, tc, weight_dtype=dtype, cache_dtype=dtype)
        torch.cuda.synchronize()
        assert cuda_lib.LAUNCHES[key] == (4 if dtype == torch.float32
                                          else -(-4 // MAX_ROWS))
        for i in range(4):
            assert torch.equal(plm.decode(model, tc[i:i + 1], weight_dtype=dtype,
                                          cache_dtype=dtype), got[i:i + 1])
        gap, scale = plain_gap(model.packed(), tc, got, model.go_id, dtype, dtype)
    assert got.shape == (4, 120)
    assert gap <= (1e-4 if dtype == torch.float32 else BF16_MARGIN) * scale, (
        gap, scale)


@pytest.mark.cuda
def test_plm_decode_serves_the_bf16_kernel_by_default(dev):
    """models/plm.decode of a greedy batch on the card runs plm_decode_bf16
    at the wrapper's defaults (bf16 weights and cache), ceil(B / MAX_ROWS)
    launches of all B rows, the float32 kernel never; each row equals the
    wrapper's own one-row call."""
    model = plm.ProsodyLM(seed=8, device="cuda")
    tc = _rand(np.random.default_rng(13), dev, 3, 60, 256)
    cuda_lib.reset_launches()
    with torch.inference_mode():
        got = plm.decode(model, tc)
        torch.cuda.synchronize()
        assert cuda_lib.LAUNCHES["plm_decode_bf16"] == -(-3 // MAX_ROWS)
        assert cuda_lib.ROWS["plm_decode_bf16"] == 3
        assert cuda_lib.LAUNCHES["plm_decode"] == 0
        for i in range(3):
            assert torch.equal(plm_decode_greedy(model.packed(), tc[i:i + 1],
                                                 model.go_id), got[i:i + 1])
        gap, scale = plain_gap(model.packed(), tc, got, model.go_id,
                               torch.bfloat16, torch.bfloat16)
    assert gap <= BF16_MARGIN * scale, (gap, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 37, 120, 800])
@pytest.mark.parametrize("rows", [2, 3, MAX_ROWS])
def test_plm_decode_rows_equal_their_one_row_launches(dev, rows, t):
    """One launch of the multi-row kernel (bf16 weights and cache) on rows
    of different latents: each row's codes equal its own one-row launch's
    bit for bit (the same sums in the same order, column by column), one
    launch of `rows` rows counted, and a repeated launch gives the same
    codes."""
    model = plm.ProsodyLM(seed=9, device="cuda")
    tc = _rand(np.random.default_rng(100 * rows + t), dev, rows, t, 256)
    w = model.packed()
    cuda_lib.reset_launches()
    with torch.inference_mode():
        got = plm_decode_greedy(w, tc, model.go_id)
        torch.cuda.synchronize()
        assert (cuda_lib.LAUNCHES["plm_decode_bf16"],
                cuda_lib.ROWS["plm_decode_bf16"]) == (1, rows)
        assert torch.equal(plm_decode_greedy(w, tc, model.go_id), got)
        one = torch.cat([plm_decode_greedy(w, tc[i:i + 1], model.go_id)
                         for i in range(rows)])
    assert got.shape == (rows, t) and got.dtype == torch.int32
    assert torch.equal(got, one), (got != one).sum(1).tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [7, 64, 192, 256])
@pytest.mark.parametrize("t", [1, 2, 7, 17, 22, 23, 101, 768])
def test_snakebeta_bf16_every_plan(dev, t, c):
    """aa_snake_bf16.cu with every segment it is planned for, and on a
    view whose start is 2 bytes off a 4-byte boundary (the
    one-channel packing), against the bf16 twin before its final rounding
    (2^-8 x max|ref|); each call counts one aa_snakebeta_bf16 launch, and
    two launches are identical."""
    rng = np.random.default_rng(31 * t + c)
    x = _rand(rng, dev, 2, t, c).bfloat16()
    a, be = (torch.exp(_rand(rng, dev, c, scale=0.3)) for _ in range(2))
    want = snake.composed_snakebeta(x.float(), a, be)
    xv = torch.empty(2 * t * c + 1, device=dev,
                     dtype=torch.bfloat16)[1:].view(2, t, c).copy_(x)
    calls = [lambda s=s: snake._launch(x, a, be, seg=s)
             for s in snake.BF16_SEGS]
    calls.append(lambda: snake.fused_aa_snakebeta(xv, a, be))
    cuda_lib.reset_launches()
    with torch.inference_mode():
        for fn in calls:
            _close_bf16(fn(), want)
        assert torch.equal(calls[0](), calls[0]())
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["aa_snakebeta_bf16"] == len(calls) + 2
    assert cuda_lib.LAUNCHES["aa_snakebeta"] == 0


@pytest.mark.cuda
def test_kernel_backward_is_plain_gradient(dev):
    """The autograd.Function backward equals autograd of the plain version."""
    rng = np.random.default_rng(0)
    c, t = 16, 64
    x = _rand(rng, dev, 1, t, c).requires_grad_()
    ws = [w.requires_grad_() for w in _block_ws(rng, dev, 3, c)]
    cot = _rand(rng, dev, 1, t, c)
    got = torch.autograd.grad(ampblock.fused_ampblock(x, *ws, 3, DIL), [x, *ws], cot)
    want = torch.autograd.grad(ampblock.composed_ampblock(x, *ws, 3, DIL), [x, *ws], cot)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def _voice(seconds, f_lo, f_hi, seed):
    """A gliding harmonic tone with a little noise, 16 kHz."""
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    f = np.linspace(f_lo, f_hi, n)
    ph = 2 * np.pi * np.cumsum(f) / 16000.0
    y = sum(0.3 / h * np.sin(h * ph) for h in range(1, 5))
    return (y + 0.01 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.cuda
def test_wav2vec2_and_yin_card_match_cpu(dev):
    cpu = Wav2Vec2(seed=3, device="cpu")
    card = Wav2Vec2(seed=3, device="cuda")
    x = torch.from_numpy(_voice(1.0, 100, 220, 1))[None]
    with torch.inference_mode():
        want = cpu(x)
        got = card(x.to(dev)).cpu()
    assert got.shape == (1, 49, 1024)  # (16000 - 400) // 320 + 1
    torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max().item(),
                               rtol=0)
    with torch.inference_mode():
        f_cpu = yin_f0(x)[0].numpy()
        f_card = yin_f0(x.to(dev))[0].cpu().numpy()
    assert ((f_cpu > 0) == (f_card > 0)).mean() >= 0.99
    both = (f_cpu > 0) & (f_card > 0)
    np.testing.assert_allclose(f_card[both], f_cpu[both], rtol=1e-4)


@pytest.mark.cuda
def test_mpnet_card_matches_cpu_and_chunks_equal_dense(dev):
    cpu = MPNet(seed=4, device="cpu")
    card = MPNet(seed=4, device="cuda")
    with torch.inference_mode():
        mag, pha = mag_pha_stft(torch.from_numpy(_voice(1.0, 150, 90, 2))[None],
                                400, 100, 400, 0.3)
        want = cpu(mag, pha)
        got = [a.cpu() for a in card(mag.to(dev), pha.to(dev))]
        card.set_attn_chunk(64)
        chunked = [a.cpu() for a in card(mag.to(dev), pha.to(dev))]
        card.set_attn_chunk(None)
    scale = want[0].abs().max().item()
    torch.testing.assert_close(got[0], want[0], atol=1e-4 * scale, rtol=0)
    big = want[0] > 1e-3 * scale
    circle = (torch.polar(torch.ones_like(got[1]), got[1])
              - torch.polar(torch.ones_like(want[1]), want[1])).abs()
    assert circle[big].max() <= 1e-3
    torch.testing.assert_close(chunked[0], got[0], atol=1e-5 * scale, rtol=0)


@pytest.mark.cuda
def test_vc_card_matches_cpu(dev, monkeypatch):
    """Full-width vc at 48 kHz, denoise_ratio 0.8, with the f0 and the
    denoiser's STFT computed once on the CPU and given to both (the card's
    RMS scaling differs from the CPU's by an ulp, enough to flip a
    first-frame phase between +-pi); every vocoder kernel launches on the
    card."""
    stft, saved = tpipe.mag_pha_stft, []

    def one_stft(y, *args):  # the CPU run's, replayed on the card
        if not saved:
            saved.extend(stft(y.cpu(), *args))
        return tuple(a.to(y.device) for a in saved)

    monkeypatch.setattr(tpipe, "mag_pha_stft", one_stft)
    src, trg = _voice(1.0, 110, 180, 5), _voice(1.5, 200, 240, 6)
    with torch.inference_mode():
        src_f0 = yin_f0(torch.from_numpy(np.pad(src, (0, 640)))[None])[0].numpy()
        trg_f0 = yin_f0(torch.from_numpy(trg)[None])[0].numpy()
    outs = []
    for d in ("cpu", "cuda"):
        pipe = tpipe.TTSPipeline(
            HierVocoder(seed=1234, device=d),
            SpeechSR(32, 3, 1, seed=4321, device=d), d,
            denoiser=MPNet(seed=5, device=d))
        w2v = Wav2Vec2(seed=6, device=d)
        seen = {}
        orig = pipe.speechsr.forward
        monkeypatch.setattr(pipe.speechsr, "forward",
                            lambda x: seen.setdefault("wav", orig(x)))
        cuda_lib.reset_launches()
        pipe.vc(src, trg, w2v, denoise_ratio=0.8, noise_scale_vc=0.0,
                output_sr=48000, src_f0=src_f0, trg_f0=trg_f0)
        if d == "cuda":
            torch.cuda.synchronize()
            assert {k: cuda_lib.LAUNCHES[k] for k in
                    ("aa_snakebeta", "ampblock", "amp_triple")} == {
                "aa_snakebeta": 19, "ampblock": 6, "amp_triple": 5}
        outs.append(seen["wav"][0, :, 0].cpu().numpy())
    assert outs[0].shape == (3 * 16640,)
    assert np.abs(outs[1] - outs[0]).max() <= 1e-3


@pytest.mark.cuda
def test_sr_train_step_card_matches_cpu(dev):
    """One SpeechSR train step (ch 32: the stage kernel with its tail,
    forward and plain-VJP backward; a one-resolution, one-period
    discriminator) on the card and on the CPU from the same weights and
    batch: losses within 1e-4 relative, G and D gradients within 1e-3
    relative L2; one amp_triple launch."""
    from megatts2_hierspeechpp_torch.models.discriminators import (
        MultiPeriodDiscriminator)
    from megatts2_hierspeechpp_torch.train import speechsr as srt

    rng = np.random.default_rng(7)
    lo = (0.1 * np.sin(np.arange(800) * 0.07)[None, :, None]
          + 0.01 * rng.standard_normal((2, 800, 1))).astype(np.float32)
    hi = (0.1 * rng.standard_normal((2, 2400, 1))).astype(np.float32)
    out = []
    for d in ("cpu", "cuda"):
        state = srt.create_state(
            SpeechSR(32, 3, 1, seed=8, device=d, train=True),
            MultiPeriodDiscriminator(((128, 32, 128),), (2,), seed=9, device=d))
        cuda_lib.reset_launches()
        state, m = srt.TrainStep(n_fft=512, hop=128, n_mels=64)(
            state, {"lo": torch.from_numpy(lo).to(d), "hi": torch.from_numpy(hi).to(d)})
        launches = cuda_lib.LAUNCHES["amp_triple"]
        out.append(({k: float(v) for k, v in m.items()},
                    [torch.cat([p.grad.flatten().cpu() for p in opt.params])
                     for opt in (state.opt_g, state.opt_d)], launches))
    (mc, gc, _), (mg, gg, launches) = out
    assert launches == 1
    for k, v in mc.items():
        assert abs(mg[k] - v) <= 1e-4 * abs(v), k
    for a, b in zip(gg, gc):
        assert ((a - b).norm() / b.norm()).item() <= 1e-3


@pytest.mark.cuda
def test_mpnet_training_remat_and_chunks_on_card(dev):
    """MPNet's training build on the card at B = 2: remat on against off
    gives the same loss and running statistics (the recompute moves them
    once), and the query-chunked attention the dense form's loss."""
    from megatts2_hierspeechpp_torch.train import denoiser as dnt

    rng = np.random.default_rng(10)
    clean = rng.uniform(-0.5, 0.5, (2, 4000)).astype(np.float32)
    noisy = clean + 0.1 * rng.standard_normal((2, 4000)).astype(np.float32)
    spectra = [a.to(dev) for w in (noisy, clean)
               for a in mag_pha_stft(torch.from_numpy(w), 400, 100, 400, 0.3)]
    res = {}
    for remat, chunk in ((False, None), (True, None), (True, 16)):
        model = MPNet(16, 2, seed=11, device="cuda", train=True, remat=remat,
                      attn_chunk=chunk)
        state = dnt.create_state(model, lr=1e-4)
        _, m = dnt.TrainStep().with_spectra(state, *spectra,
                                            torch.from_numpy(clean).to(dev))
        res[(remat, chunk)] = (float(m["loss/total"]), {
            k: v.cpu() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var", "num_batches_tracked"))})
    loss, stats = res[(False, None)]
    assert res[(True, None)][0] == pytest.approx(loss, rel=1e-6)
    for k, v in stats.items():
        torch.testing.assert_close(res[(True, None)][1][k], v, rtol=0,
                                   atol=1e-6 * v.abs().max().item())
    assert res[(True, 16)][0] == pytest.approx(loss, rel=1e-5)
