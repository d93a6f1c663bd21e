"""The port's CUDA kernels against their plain versions, on a card. Skips
without one. Imports only torch and the port, so it runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: atol 1e-5, rtol 1e-4 for the snake; 1e-4 for the conv kernels
(accumulation order over k*C terms; the split-TF32 products are as accurate
as float32, a single TF32 pass would fail it, see test_torch_tf32split.py). The PLM decode kernel's codes must pass
the teacher-forced check (each code within 1e-4 x max|logits| of its row's
max logit), since one near-tie flip changes every later step."""
import numpy as np
import pytest
import torch

from megatts2_hierspeechpp_torch.models import plm
from megatts2_hierspeechpp_torch.nn.conv import conv1d_op
from megatts2_hierspeechpp_torch.ops import amp_triple, ampblock, cuda_lib, snake
from megatts2_hierspeechpp_torch.ops.plm_decode import plain_decode, plm_decode_greedy
from megatts2_hierspeechpp_torch.ops.resample import activation1d

DIL = (1, 3, 5)
CHANNELS = (7, 8, 16, 32, 48, 64, 128)  # 7: the 4-byte copy path, ragged tiles
KERNEL_SIZES = (3, 5, 7, 11)
# T = 1, 7, both sides of a time tile edge (snake_conv's tiles are 32, 64 or
# 128 samples; at B = 2 and T near 128 it takes 32-sample tiles, near 8448 on
# a 132-SM card the 128-sample ones), and 4097
LENGTHS = (1, 7, 127, 128, 129, 4097, 8447, 8448, 8449)


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


def _plain_snake_conv(x, a, ib, w, bias, d, res=None):
    y = activation1d(x, lambda v: v + torch.sin(v * a).square() * ib)
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
    assert cuda_lib.LAUNCHES == {"aa_snakebeta": 1, "ampblock": 1,
                                 "amp_triple": 2, "plm_decode": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 37, 300, 500, 1100])
def test_plm_decode_kernel_matches_plain(dev, t):
    """The persistent decode kernel at full width (d = 276, 4 layers, 1024
    bins): one launch, codes that pass the teacher-forced check, mostly the
    plain greedy decode's codes. At T = 1100 the keys outgrow 32 splits of
    32, so a split holds more than one 32-key chunk."""
    model = plm.ProsodyLM(seed=3, device="cuda")
    rng = np.random.default_rng(t)
    tc = _rand(rng, dev, 1, t, 256)
    w = model.packed()
    cuda_lib.reset_launches()
    with torch.inference_mode():
        got = plm_decode_greedy(w, tc, model.go_id)
        torch.cuda.synchronize()
        assert cuda_lib.LAUNCHES["plm_decode"] == 1
        want = plain_decode(w, tc, model.go_id)
        assert torch.equal(plm.decode(model, tc), got)
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
    with torch.inference_mode():
        first = plm_decode_greedy(w, tc, model.go_id)
        for _ in range(9):
            assert torch.equal(plm_decode_greedy(w, tc, model.go_id), first)


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
