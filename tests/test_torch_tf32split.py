"""Split TF32 ("3xTF32") against single-pass TF32, emulated on the CPU.

csrc/snake_conv.cu runs its conv products on the tensor cores as
a_hi*b_hi + a_hi*b_lo + a_lo*b_hi, with a_hi = tf32(a) and a_lo =
tf32(a - a_hi) (cvt.rna.tf32.f32: round to nearest, ties away from zero, on
the 13 low mantissa bits). Here the plain AMPBlock (`composed_ampblock`)
runs with its conv products rounded that way: three passes stay within
1e-5 x max|ref| of float32, one pass does not meet the kernels' 1e-4 x
max|ref| check on the card. So that check tells the two apart.

A tf32 x tf32 product is exact in float32 (11 + 11 significant bits), so a
float32 matmul of rounded operands is the tensor cores' product; only the
order of the sums differs.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from megatts2_hierspeechpp_torch.ops import ampblock

TOL = 1e-4  # the on-card check of snake_conv, AMPBlock and triple


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Cap torch's intra-op threads while these tests run, so the suite's
    worker processes do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def tf32(a: torch.Tensor) -> torch.Tensor:
    """Round float32 to tf32 as cvt.rna does (magnitude += half an ulp of
    tf32, then the 13 low bits cleared: ties away from zero)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(a: torch.Tensor):
    hi = tf32(a)
    return hi, tf32(a - hi)


def conv_tf32(passes: int):
    """conv1d_op with its products in `passes` (1 or 3) TF32 products."""

    def conv(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
        assert stride == 1 and groups == 1
        t = x.shape[1]
        xp = F.pad(x, (0, 0, padding, padding))
        xh, xl = split(xp)
        y = torch.zeros(x.shape[0], t, weight.shape[0])
        for j in range(weight.shape[-1]):
            wh, wl = split(weight[:, :, j].t().contiguous())
            sl = slice(j * dilation, j * dilation + t)
            if passes == 3:
                y = y + xl[:, sl] @ wh + xh[:, sl] @ wl
            y = y + xh[:, sl] @ wh
        return y if bias is None else y + bias

    return conv


def _block(rng, c, k, t):
    f = lambda *s, scale=1.0: torch.from_numpy(
        (rng.standard_normal(s) * scale).astype(np.float32))
    pos = lambda: torch.exp(f(3, c, scale=0.2))
    w = lambda: f(3, k, c, c, scale=(c * k) ** -0.5)
    b = lambda: f(3, c, scale=0.05)
    return f(1, t, c), (pos(), pos(), w(), b(), pos(), pos(), w(), b())


def test_tf32_rounding_is_round_to_nearest_away():
    one = 1.0 + 2.0 ** -10  # a tf32 value: 10 explicit mantissa bits
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                      one, 3.0], dtype=torch.float32)
    assert tf32(x).tolist() == [one, -one, 1.0, one, 3.0]
    hi, lo = split(torch.tensor([1.0 + 2.0 ** -11 + 2.0 ** -20]))
    assert (hi + lo).item() == 1.0 + 2.0 ** -11 + 2.0 ** -20


@pytest.mark.parametrize("c,k", [(128, 11), (16, 3)])
def test_split_tf32_is_float32_accurate_and_single_pass_is_not(monkeypatch, c, k):
    x, ws = _block(np.random.default_rng(c + k), c, k, 256)
    dil = (1, 3, 5)
    ref = ampblock.composed_ampblock(x, *ws, k, dil)
    scale = ref.abs().max().item()
    err = {}
    for passes in (1, 3):
        monkeypatch.setattr(ampblock, "conv1d_op", conv_tf32(passes))
        err[passes] = (ampblock.composed_ampblock(x, *ws, k, dil) - ref).abs().max().item()
    assert err[3] <= 1e-5 * scale, err
    assert err[1] > TOL * scale, err
