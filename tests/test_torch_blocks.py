"""Port modules (megatts2_hierspeechpp_torch.nn / ops) against their JAX
counterparts under `model.apply`, on the CPU, with the port's weights carried
over from the JAX params by megatts2_hierspeechpp_torch.convert.

JAX params are perturbed away from their init (weight-norm v ~ 1e-2, snake
logs at 0) so every path carries O(1) signals. Tolerance: atol 1e-4."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megatts2_hierspeechpp_torch import convert
from megatts2_hierspeechpp_torch.nn import conv as tconv
from megatts2_hierspeechpp_torch.nn.activations import AASnakeBeta
from megatts2_hierspeechpp_torch.nn.dit import ResidualCouplingBlockTransformer
from megatts2_hierspeechpp_torch.nn.resblocks import AMPBlock
from megatts2_hierspeechpp_torch.nn.styleencoder import StyleEncoder
from megatts2_hierspeechpp_torch.nn.wavenet import WN
from megatts2_hierspeechpp_torch.ops import resample as tres
from megatts2_hierspeechpp_tpu.nn import activations as jact
from megatts2_hierspeechpp_tpu.nn import conv as jconv
from megatts2_hierspeechpp_tpu.nn import dit as jdit
from megatts2_hierspeechpp_tpu.nn import resblocks as jres
from megatts2_hierspeechpp_tpu.nn import styleencoder as jstyle
from megatts2_hierspeechpp_tpu.nn import wavenet as jwn
from megatts2_hierspeechpp_tpu.models import vocoder as jvoc
from megatts2_hierspeechpp_torch.models import vocoder as tvoc
from megatts2_hierspeechpp_tpu.ops import resample as jresample
from tests.test_torch_kernels import few_torch_threads  # noqa: F401

ATOL = 1e-4


def _init(module, *args, scale=0.1, seed=0, **kw):
    """JAX params of `module`, perturbed by scale * N(0, 1)."""
    params = jax.jit(lambda *a: module.init(jax.random.PRNGKey(seed), *a, **kw))(
        *args)["params"]
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(
        lambda p: np.asarray(p) + scale * rng.standard_normal(p.shape).astype(
            np.float32), params)


def _apply(module, params, *args, **kw):
    return jax.jit(lambda p, *a: module.apply({"params": p}, *a, **kw))(
        params, *args)


def _state(fill, params):
    sd = {}
    fill(sd, "", params)
    return sd


def _load(port, fill, params):
    port.load_state_dict(_state(fill, params), strict=True)
    return port.eval()


def _check(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("stride,padding,dilation", [(1, 3, 1), (4, 4, 1),
                                                     (1, 6, 3), (2, 0, 1)])
def test_conv1d(stride, padding, dilation):
    x = _x(2, 40, 6)
    jm = jconv.Conv1d(5, 7, stride=stride, padding=padding, dilation=dilation)
    p = _init(jm, x)
    tm = _load(tconv.Conv1d(6, 5, jm.kernel_size, stride, padding, dilation),
               convert.conv1d, p)
    _check(tm(torch.from_numpy(x)), _apply(jm, p, x))


@pytest.mark.parametrize("k,dilation", [(1, 1), (5, 1), (3, 5)])
def test_wn_conv1d(k, dilation):
    x = _x(2, 32, 6)
    pad = tconv.get_padding(k, dilation)
    jm = jconv.WNConv1d(8, k, padding=pad, dilation=dilation)
    p = _init(jm, x)
    tm = _load(tconv.WNConv1d(6, 8, k, padding=pad, dilation=dilation),
               convert.wn_conv1d, p)
    _check(tm(torch.from_numpy(x)), _apply(jm, p, x))


@pytest.mark.parametrize("u,k", [(4, 8), (5, 11), (2, 4)])
def test_wn_conv_transpose1d(u, k):
    x = _x(1, 12, 8)
    jm = jconv.WNConvTranspose1d(4, k, stride=u, padding=(k - u) // 2)
    p = _init(jm, x)
    tm = _load(tconv.WNConvTranspose1d(8, 4, k, stride=u, padding=(k - u) // 2),
               convert.wn_conv_transpose1d, p)
    out = tm(torch.from_numpy(x))
    assert out.shape == (1, 12 * u, 4)
    _check(out, _apply(jm, p, x))


def test_resample_ops():
    x = _x(2, 50, 3)
    xt = torch.from_numpy(x)
    _check(tres.upsample1d(xt), jresample.upsample1d(jnp.asarray(x)))
    _check(tres.downsample1d(xt), jresample.downsample1d(jnp.asarray(x)))
    _check(tres.activation1d(xt, torch.tanh),
           jresample.activation1d(jnp.asarray(x), jnp.tanh))
    np.testing.assert_array_equal(tres.kaiser_sinc_filter1d(0.25, 0.3, 12),
                                  jresample.kaiser_sinc_filter1d(0.25, 0.3, 12))


@pytest.mark.parametrize("c", [16, 256])
def test_aa_snakebeta(c):
    x = _x(1, 48, c)
    jm = jact.AASnakeBeta(c)
    p = _init(jm, x, scale=0.3)
    tm = _load(AASnakeBeta(c), convert.snake, p)
    _check(tm(torch.from_numpy(x)), _apply(jm, p, x))


@pytest.mark.parametrize("c,k", [(16, 11), (64, 3), (256, 7)])
def test_ampblock(c, k):
    """C <= 128 dispatches to fused_ampblock, C = 256 runs layer by layer
    through fused_aa_snakebeta (the JAX TPU dispatch); the JAX module on
    CPU runs its composed path."""
    x = _x(1, 64, c)
    jm = jres.AMPBlock(c, k, (1, 3, 5))
    p = _init(jm, x)
    tm = _load(AMPBlock(c, k, (1, 3, 5)), convert.ampblock, p)
    _check(tm(torch.from_numpy(x)), _apply(jm, p, x))


def test_wn_with_global_conditioning():
    x, g = _x(2, 20, 12), _x(2, 1, 10, seed=1)
    mask = np.ones((2, 20, 1), np.float32)
    mask[1, 15:] = 0
    jm = jwn.WN(12, 5, 1, 4, gin_channels=10)
    p = _init(jm, x, mask, g=g)
    tm = _load(WN(12, 5, 1, 4, gin_channels=10), convert.wn, p)
    _check(tm(*map(torch.from_numpy, (x, mask, g))),
           _apply(jm, p, x, mask, g=g))


def test_style_encoder_padding_quirk():
    """Pooling sums over all frames but divides by the true length."""
    x = _x(2, 24, 80)
    mask = np.ones((2, 24, 1), np.float32)
    mask[1, 18:] = 0
    jm = jstyle.StyleEncoder(80, 64, 32)
    p = _init(jm, x, mask, scale=0.05)
    tm = _load(StyleEncoder(80, 64, 32), convert.style_encoder, p)
    _check(tm(torch.from_numpy(x), torch.from_numpy(mask)),
           _apply(jm, p, x, mask))


def test_dit_flow_reverse():
    x, g = _x(2, 16, 12), _x(2, 20, seed=1)
    mask = np.ones((2, 16, 1), np.float32)
    mask[0, 12:] = 0
    jm = jdit.ResidualCouplingBlockTransformer(12, 32, n_layers=2, n_flows=2,
                                               gin_channels=20)
    p = _init(jm, x, mask, g, reverse=True, scale=0.05)
    tm = _load(ResidualCouplingBlockTransformer(12, 32, 2, 2, 20),
               convert.dit_coupling_block, p)
    _check(tm.reverse(*map(torch.from_numpy, (x, mask, g))),
           _apply(jm, p, x, mask, g, reverse=True))


def test_source_network_and_generator_both_stage_paths():
    """At upsample_initial_channel 256 the first stage (C=128) runs block by
    block and averages in Python, the second (C=64) as one
    fused_amp_triple call; in the Generator the second is the last stage, so
    the triple also takes the tail."""
    z, g = _x(1, 6, 24), _x(1, 16, seed=1)
    jsn = jvoc.SourceNetwork(256, 24, 16)
    p = _init(jsn, z, g, scale=0.02)
    tsn = tvoc.SourceNetwork(256, 24, 16)
    tsn.load_state_dict(_state(convert.source_network, p))
    e, e_ = tsn(torch.from_numpy(z), torch.from_numpy(g))
    je, je_ = _apply(jsn, p, z, g)
    assert e.shape == (1, 24, 64)
    _check(e, je)
    _check(e_, je_)

    jgen = jvoc.Generator(24, upsample_rates=(4, 2), upsample_initial_channel=256,
                          upsample_kernel_sizes=(8, 4), gin_channels=16)
    pitch = np.array(je)
    p = _init(jgen, z, pitch, g, scale=0.02)
    tgen = tvoc.Generator(24, upsample_rates=(4, 2), upsample_initial_channel=256,
                          upsample_kernel_sizes=(8, 4), gin_channels=16,
                          pitch_channels=64)
    tgen.load_state_dict(_state(convert.generator, p))
    wav = tgen(*map(torch.from_numpy, (z, pitch, g)))
    assert wav.shape == (1, 48, 1)
    _check(wav, _apply(jgen, p, z, pitch, g))

