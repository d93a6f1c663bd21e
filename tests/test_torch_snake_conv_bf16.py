"""The bf16 configuration of the snake-conv kernel (csrc/snake_conv_bf16.cu),
checked on the CPU:

- its launch plan (`ampblock.snake_conv_bf16_plan`, the mirror of the
  kernel's `plan_of`) at every bf16 launch shape of the serving, bench,
  training and eval paths: shared memory within a Hopper block's 232,448
  bytes, wgmma's N a multiple of 8 and its K steps whole k16 steps, the
  window holding every row a tap's wgmma reads, and 132 SMs filled wherever
  B x T has the 64-row tiles to fill them; the kernel's constants equal the
  mirror's;
- the packed-weight cache of `nn.resblocks.AMPBlock.packed_bf16`: one pack
  per parameter version, none on a repeated call, a new one after an
  in-place optimizer step and after `load_state_dict`, its values
  `w.to(torch.bfloat16)` in the B operand's core-matrix layout;
- the kernel's arithmetic, emulated: bf16 operands, float32 sums of one
  k16 step each, added tap by tap and step by step in the kernel's order.
  On a 6-conv AMPBlock at C = 128, k = 11, T = 4096 it stays within
  2^-8 x max|ref| of the bf16 twin (`block_math(bf16_products=True)`)
  before the final rounding, and no farther from the float32 block than
  twice the twin is; an accumulator rounded to bf16 after each tap (what a
  bf16-accumulating kernel would do) misses the first bound, so the check
  tells the two apart.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from megatts2_hierspeechpp_torch.nn import resblocks
from megatts2_hierspeechpp_torch.nn.resblocks import AMPBlock, stage_packs
from megatts2_hierspeechpp_torch.ops import ampblock

SRC = Path(ampblock.__file__).parents[1] / "csrc" / "snake_conv_bf16.cu"
BF16_MARGIN = 2.0 ** -8   # half a bf16 step, x max|ref|
EXACT_RATIO = 2.0         # a bf16 chain's distance from float32 over its twin's
SMS = 132

GEN = (3, 7, 11)
SN = (3, 5, 7)
# (label, B, T, C, kernel sizes): every bf16 AMPBlock / stage launch shape of
# the paths: serving at B = 1 (100 / 250 / 500 frames) and a B = 4 bucket of
# 600 frames, bench.py's B = 4 x 1000 frames, vocoder training and its eval
# at B = 32 (32-frame windows: Generator x 20 / 80 / 160 / 320 samples a
# frame, SourceNetwork x 2 / 4, the posterior encoder's enc_q), SpeechSR
# training (16, 9600, 32) / (16, 4800, 32) and its eval (4, 9600, 32)
PATH_SHAPES = [
    *[(f"serve {f} frames {name}", 1, m * f, c, ks)
      for f in (100, 250, 500)
      for name, m, c, ks in (("Gen C=128", 20, 128, GEN), ("Gen C=64", 80, 64, GEN),
                             ("Gen C=32", 160, 32, GEN), ("Gen C=16", 320, 16, GEN),
                             ("SN C=128", 2, 128, SN), ("SN C=64", 4, 64, SN),
                             ("SR C=32", 960, 32, GEN))],
    *[(f"{label} {name}", 4, m * f, c, ks)
      for label, f in (("serve_batch B=4", 600), ("bench B=4", 1000))
      for name, m, c, ks in (("Gen C=128", 20, 128, GEN), ("Gen C=64", 80, 64, GEN),
                             ("Gen C=32", 160, 32, GEN), ("Gen C=16", 320, 16, GEN),
                             ("SN C=128", 2, 128, SN), ("SN C=64", 4, 64, SN),
                             ("SR C=32", 960, 32, GEN))],
    *[(f"train B=32 {name}", 32, t, c, ks)
      for name, t, c, ks in (("enc_q C=32", 5120, 32, GEN), ("enc_q C=32", 7680, 32, GEN),
                             ("enc_q C=64", 1024, 64, GEN), ("enc_q C=64", 1536, 64, GEN),
                             ("Gen C=128", 256, 128, GEN), ("Gen C=128", 384, 128, GEN),
                             ("Gen C=128", 640, 128, GEN), ("SN C=128", 64, 128, SN),
                             ("Gen C=64", 2560, 64, GEN), ("Gen C=32", 5120, 32, GEN),
                             ("Gen C=16", 10240, 16, GEN), ("SN C=64", 128, 64, SN))],
    *[(f"eval B=32 {name}", 32, t, c, ks)
      for name, t, c, ks in (("Gen C=128", 3840, 128, GEN), ("SN C=128", 384, 128, SN),
                             ("Gen C=64", 15360, 64, GEN), ("Gen C=32", 30720, 32, GEN),
                             ("Gen C=16", 61440, 16, GEN), ("SN C=64", 768, 64, SN))],
    ("train SR 48k", 16, 9600, 32, GEN),
    ("train SR 24k", 16, 4800, 32, GEN),
    ("eval SR", 4, 9600, 32, GEN),
]


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Cap torch's intra-op threads while these tests run, so the suite's
    worker processes do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("label,b,t,c,ks", PATH_SHAPES,
                         ids=[s[0] for s in PATH_SHAPES])
def test_plan_fits_and_fills_the_card(label, b, t, c, ks):
    for k in ks:
        for d in (1, 3, 5):
            _check_plan(b, t, c, k, d)


def _check_plan(b, t, c, k, d):
    p = ampblock.snake_conv_bf16_plan(b, t, c, c, k, d)
    assert p["smem"] <= ampblock.SMEM_LIMIT
    m, n, kk = p["wgmma"]
    assert m == 64 and n == p["tn"] and n % 8 == 0 and 16 <= n <= 256
    assert kk == 16 and p["cinp"] % 16 == 0 and p["k16_steps"] * 16 == p["cinp"]
    assert p["cinp"] >= c and p["coutp"] >= c and p["coutp"] % p["tn"] == 0
    # the tile is 64-row sub-blocks: one warpgroup at tm 64, else two with
    # tm / 128 each, and the accumulators of MS_max sub-blocks a warpgroup
    ms = {128: 1, 64: 2}.get(p["tn"], 4)
    assert p["tm"] == 64 or (p["tm"] % 128 == 0 and p["tm"] // 128 <= ms)
    # the last tap of the last sub-block reads rows up to tm - 1 + (k - 1) d
    assert p["tm"] - 1 + (k - 1) * d < p["wr"]
    assert p["tiles"] == b * math.ceil(t / p["tm"]) * (p["coutp"] // p["tn"])
    assert p["grid"] == min(p["tiles"], SMS)
    if b * math.ceil(t / 64) * (p["coutp"] // 16) >= SMS:
        assert p["grid"] == SMS, p


def test_plan_picks_the_widest_tile_that_fills():
    """Long shapes take the longest tiles of all of Cout; short ones 64
    rows with Cout split until the card is full; nothing past 128
    channels."""
    p = ampblock.snake_conv_bf16_plan(4, 960_000, 32, 32, 11, 5)
    assert (p["tm"], p["tn"], p["ring"]) == (512, 32, 11)  # all taps resident
    p = ampblock.snake_conv_bf16_plan(1, 10_000, 128, 128, 11, 5)
    assert (p["tm"], p["tn"], p["ring"], p["grid"]) == (64, 128, 4, SMS)
    p = ampblock.snake_conv_bf16_plan(1, 1_000, 128, 128, 7, 5)
    assert (p["tm"], p["tn"], p["tiles"], p["ring"]) == (64, 16, 128, 4)
    p = ampblock.snake_conv_bf16_plan(4, 80_000, 128, 128, 11, 5)
    assert (p["tm"], p["tn"], p["ring"]) == (128, 128, 4)
    assert p["smem"] == 226_400
    p = ampblock.snake_conv_bf16_plan(1, 7, 7, 7, 3, 1)
    assert (p["cinp"], p["coutp"], p["tm"], p["tn"]) == (16, 16, 64, 16)
    for bad in ((1, 100, 129, 128, 3, 1), (1, 100, 64, 200, 3, 1),
                (0, 100, 64, 64, 3, 1), (1, 100, 64, 64, 3, 0),
                (1, 100_000, 16, 128, 3, 1)):  # N past Cin_p: not built
        with pytest.raises(ValueError, match="no plan"):
            ampblock.snake_conv_bf16_plan(*bad)


def test_plan_constants_are_the_kernels():
    src = SRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    # two consumer warpgroups (the plan's 64-row sub-blocks), eight
    # producer warps (nseg = kProducers / Cin_p row runs), two windows
    assert "constexpr int kThreads = kConsumers + kProducers;" in src
    assert const("kConsumers") == 2 * 128 and const("kProducers") == 256
    assert const("kWinSlots") == 2
    assert "for (int r : {%s})" % ", ".join(map(str, ampblock.SC16_RINGS)) in src
    assert "if (tn == coutp && smem_of(tm, tn, K) <= smem_max) return K;" in src
    assert "return n >= 128 ? 1 : n == 64 ? 2 : 4;" in src
    assert "return (tm + (K - 1) * dil + 7) / 8 * 8 + 2;" in src
    for n in (16, 32, 64, 128):
        assert f"m64n{n}k16.f32.bf16.bf16" in src
        for ks in (1, 2, 4, 8):  # every (N, Cin_p / 16) a plan can give
            assert (f"SNAKE_CONV_BF16_CASE({n}, {ks})" in src) == (n <= 16 * ks)


def test_snake_conv_refuses_unplanned_shapes():
    """A bf16 launch the kernel has no plan for raises with its shape
    before anything is launched (the checks run on the CPU too)."""
    x = torch.zeros(1, 8, 200, dtype=torch.bfloat16)
    w = (torch.ones(200), torch.ones(200), torch.zeros(3, 200, 200),
         torch.zeros(200), 1)
    with pytest.raises(ValueError, match="Cin=200 Cout=200"):
        ampblock.snake_conv(x, *w, bf16_mma=True)


def _unpack(wp, cout, cin):
    """The packed layout back to (..., k, Cout, Cin)."""
    *lead, k, no, ni, _, _ = wp.shape
    full = wp.transpose(-3, -2).reshape(*lead, k, 8 * no, 8 * ni)
    return full, full[..., :cout, :cin]


@pytest.mark.parametrize("cout,cin", [(16, 16), (32, 32), (128, 128), (7, 48)])
def test_pack_is_the_rounded_weight_in_core_matrices(cout, cin):
    rng = np.random.default_rng(cout + cin)
    w = torch.from_numpy(rng.standard_normal((3, 5, cout, cin)).astype(np.float32))
    wp = ampblock.pack_bf16(w)
    op, ip = ampblock.padded_channels(cout), ampblock.padded_channels(cin)
    assert wp.dtype == torch.bfloat16 and wp.is_contiguous()
    assert wp.shape == (3, 5, op // 8, ip // 8, 8, 8)
    full, core = _unpack(wp, cout, cin)
    assert torch.equal(core, w.to(torch.bfloat16))
    assert not full[..., cout:, :].any() and not full[..., :, cin:].any()
    # element [n, kg, r, e] is w[8 n + r, 8 kg + e]: one 8 x 8 core matrix
    # of 16-byte rows, a tap's output-channel tiles contiguous
    n, kg, r, e = op // 8 - 1, 0, 3, 5
    if 8 * n + r < cout:
        assert wp[1, 2, n, kg, r, e] == w[1, 2, 8 * n + r, 8 * kg + e].to(torch.bfloat16)


def _block(c=16, k=3, seed=0):
    blk = AMPBlock(c, k)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    return blk


def _stacked(blk):
    _, _, w1, _, _, _, w2, _ = blk.fused_weights()
    return w1.detach(), w2.detach()


def test_pack_cache_one_pack_per_parameter_version(monkeypatch):
    calls = []
    real = resblocks.pack_bf16
    monkeypatch.setattr(resblocks, "pack_bf16",
                        lambda w: calls.append(w.shape) or real(w))
    blk = _block()
    p1 = blk.packed_bf16()
    assert len(calls) == 2  # w1 and w2, once
    assert blk.packed_bf16() is p1 and len(calls) == 2  # a repeated call
    for got, w in zip(p1, _stacked(blk)):
        assert torch.equal(_unpack(got, 16, 16)[1], w.to(torch.bfloat16))

    # an in-place optimizer step: a new pack of the new weights
    opt = torch.optim.SGD(blk.parameters(), lr=0.5)
    blk.zero_grad()
    blk(torch.randn(1, 40, 16)).square().sum().backward()
    opt.step()
    p2 = blk.packed_bf16()
    assert p2 is not p1 and len(calls) == 4
    assert blk.packed_bf16() is p2 and len(calls) == 4
    for got, old, w in zip(p2, p1, _stacked(blk)):
        assert torch.equal(_unpack(got, 16, 16)[1], w.to(torch.bfloat16))
        assert not torch.equal(got, old)

    # load_state_dict writes the parameters in place: a new pack again
    other = _block(seed=1)
    blk.load_state_dict(other.state_dict())
    p3 = blk.packed_bf16()
    assert p3 is not p2 and len(calls) == 6
    for got, w in zip(p3, _stacked(other)):
        assert torch.equal(_unpack(got, 16, 16)[1], w.to(torch.bfloat16))

    # a replaced parameter (new storage) too
    blk.convs2[1].weight_v = torch.nn.Parameter(blk.convs2[1].weight_v.detach() * 2)
    p4 = blk.packed_bf16()
    assert p4 is not p3 and len(calls) == 8
    assert torch.equal(_unpack(p4[1], 16, 16)[1], _stacked(blk)[1].to(torch.bfloat16))


def test_cpu_and_float32_paths_take_no_pack(monkeypatch):
    """Only a bf16 x on the card needs the pack: the module path on the CPU
    (the plain version) and in float32 never builds one."""
    calls = []
    monkeypatch.setattr(resblocks, "pack_bf16", lambda w: calls.append(w) or w)
    blk = _block()
    x = torch.randn(1, 40, 16)
    blk(x)
    blk(x.bfloat16())
    assert stage_packs([blk], x.bfloat16()) is None and not calls


def _conv_wgmma(round_acc=False):
    """conv1d_op (B, T, Cin) x (Cout, Cin, K) with the kernel's sums: per
    tap, per 16-channel step, a float32 product of 16 exact bf16 x bf16
    terms added to the float32 accumulator (`round_acc`: the accumulator
    rounded to bf16 after each tap, a wrong kernel)."""

    def conv(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
             compute_dtype=None):
        assert stride == 1 and groups == 1
        t = x.shape[1]
        xp = F.pad(x, (0, 0, padding, padding))
        y = torch.zeros(x.shape[0], t, weight.shape[0])
        for j in range(weight.shape[-1]):
            sl = slice(j * dilation, j * dilation + t)
            for c0 in range(0, x.shape[-1], 16):
                y = y + xp[:, sl, c0:c0 + 16] @ weight[:, c0:c0 + 16, j].t()
            if round_acc:
                y = y.bfloat16().float()
        return y if bias is None else y + bias

    return conv


def _ws(rng, c, k):
    f = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * scale).astype(np.float32))
    pos = lambda: torch.exp(f(3, c, scale=0.2))  # noqa: E731
    w = lambda: f(3, k, c, c, scale=(c * k) ** -0.5)  # noqa: E731
    b = lambda: f(3, c, scale=0.05)  # noqa: E731
    return f(1, 4096, c), (pos(), pos(), w(), b(), pos(), pos(), w(), b())


def test_wgmma_sums_keep_the_twin(monkeypatch):
    c, k, dil = 128, 11, (1, 3, 5)
    x, ws = _ws(np.random.default_rng(11), c, k)
    x = x.bfloat16().float()  # the block's input is bf16
    with torch.no_grad():
        f32 = ampblock.block_math(x, *ws, k, dil)
        twin = ampblock.block_math(x, *ws, k, dil, bf16_products=True)
        scale = twin.abs().max().item()
        got = {}
        for wrong in (False, True):
            monkeypatch.setattr(ampblock, "conv1d_op", _conv_wgmma(wrong))
            got[wrong] = ampblock.block_math(x, *ws, k, dil, bf16_products=True)
    err = (got[False] - twin).abs().max().item()
    assert err <= BF16_MARGIN * scale, (err, scale)
    d_kernel = (got[False].bfloat16().float() - f32).abs().max().item()
    d_twin = (twin.bfloat16().float() - f32).abs().max().item()
    assert d_kernel <= EXACT_RATIO * d_twin, (d_kernel, d_twin)
    err_wrong = (got[True] - twin).abs().max().item()
    assert err_wrong > BF16_MARGIN * scale, (err_wrong, scale)
