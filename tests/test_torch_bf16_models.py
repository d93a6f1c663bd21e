"""The bf16 compute of the port's vocoder-side models on the CPU against the
JAX package's bf16 modules built from the same weights: the Generator, the
HierVocoder forward and SpeechSR-48k, small widths; and the bf16 builds'
parameters (float32, the same for a seed in both dtypes, carried through
the converters both ways).

Two bf16 paths in two frameworks cannot meet float32 tolerances against
each other, so each is held against the float32 JAX forward of the same
weights, by max |out - f32| / max |f32|. The JAX side runs twice: its CPU
composed path (bf16 intermediates throughout) and with the fused gate
forced into Pallas interpret mode (what the TPU computes, less the
kernels' bf16 conv operands, which interpret mode keeps in float32). The
port's distance must be at most EXACT_RATIO (2) x the interpret path's,
the pattern of chip_smoke.py's card-against-CPU gates; each distance is
printed on failure."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from megatts2_hierspeechpp_torch import convert
from megatts2_hierspeechpp_torch.models.discriminators import (
    MultiPeriodDiscriminator as TorchMPD,
)
from megatts2_hierspeechpp_torch.models.speechsr import SpeechSR as TorchSR
from megatts2_hierspeechpp_torch.models.vocoder import Generator as TorchGenerator
from megatts2_hierspeechpp_torch.models.vocoder import HierVocoder as TorchVocoder
from megatts2_hierspeechpp_tpu.models import convert as jconvert
from megatts2_hierspeechpp_tpu.models.speechsr import SpeechSR as JaxSR
from megatts2_hierspeechpp_tpu.models.vocoder import Generator as JaxGenerator
from megatts2_hierspeechpp_tpu.models.vocoder import HierVocoder as JaxVocoder
from megatts2_hierspeechpp_tpu.utils import convert_ref
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_train_modules import MPD_SMALL
from tests.test_torch_vocoder import SMALL, _inputs, random_params

EXACT_RATIO = 2.0
BF16 = torch.bfloat16
# tests/test_pallas_amp_triple.py's Generator: stages C = 32 and 16, both
# whole-stage triples, the last with the tail
GEN_SMALL = dict(initial_channel=32, upsample_initial_channel=64,
                 upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                 gin_channels=16)


@pytest.fixture()
def jax_paths(monkeypatch):
    """run(module, params, *args): the JAX module's output (first element of
    a tuple) on its CPU composed path, or with `interpret` on the TPU
    dispatch with every pallas_call in interpret mode."""
    orig = pl.pallas_call

    def run(module, params, *args, interpret=False):
        with monkeypatch.context() as m:
            if interpret:
                m.setattr(pl, "pallas_call",
                          lambda *a, **k: orig(*a, **dict(k, interpret=True)))
                m.setattr(jax, "default_backend", lambda: "tpu")
            out = module.apply({"params": params}, *args)
        out = out[0] if isinstance(out, tuple) else out
        return np.asarray(out, np.float32)

    return run


def _distances(port, f32, composed, interp):
    scale = np.abs(f32).max()
    return {name: float(np.abs(v - f32).max() / scale) for name, v in
            (("port", port), ("jax_composed", composed), ("jax_interpret", interp))}


def _check(d):
    assert d["port"] <= EXACT_RATIO * d["jax_interpret"], d


def test_bf16_generator_against_jax(jax_paths):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 40, 32)).astype(np.float32)
    pitch = rng.standard_normal((1, 160, 9)).astype(np.float32)
    g = rng.standard_normal((1, 16)).astype(np.float32)
    params = random_params(JaxGenerator(**GEN_SMALL), 3, x, pitch, g)
    f32 = jax_paths(JaxGenerator(**GEN_SMALL), params, x, pitch, g)
    jb = JaxGenerator(**GEN_SMALL, dtype=jnp.bfloat16)
    composed = jax_paths(jb, params, x, pitch, g)
    interp = jax_paths(jb, params, x, pitch, g, interpret=True)
    tm = TorchGenerator(**GEN_SMALL, pitch_channels=9, dtype=BF16)
    sd = {}
    convert.generator(sd, "", params)
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        port = tm(*map(torch.from_numpy, (x, pitch, g)))
    assert port.dtype == BF16 and port.shape == (1, 320, 1)
    _check(_distances(port.float().numpy(), f32, composed, interp))


def test_bf16_vocoder_forward_against_jax(jax_paths):
    args = _inputs(seed=5)
    params = random_params(JaxVocoder(**SMALL), 1, *_inputs())
    f32 = jax_paths(JaxVocoder(**SMALL), params, *args)
    jb = JaxVocoder(**SMALL, dtype=jnp.bfloat16)
    composed = jax_paths(jb, params, *args)
    interp = jax_paths(jb, params, *args, interpret=True)
    tm = TorchVocoder(**SMALL, device="cpu", dtype=BF16)
    tm.load_state_dict(convert.vocoder_from_jax(params), strict=True)
    with torch.no_grad():
        port, e_ = tm(*map(torch.from_numpy, args))
    assert port.dtype == e_.dtype == BF16
    _check(_distances(port.float().numpy(), f32, composed, interp))


def test_bf16_speechsr_against_jax(jax_paths):
    x = (np.random.default_rng(4).standard_normal((1, 600, 1)) * 0.1).astype(np.float32)
    params = random_params(JaxSR(upsample_initial_channel=16), 2, x)
    f32 = jax_paths(JaxSR(upsample_initial_channel=16), params, x)
    jb = JaxSR(upsample_initial_channel=16, dtype=jnp.bfloat16)
    composed = jax_paths(jb, params, x)
    interp = jax_paths(jb, params, x, interpret=True)
    tm = TorchSR(16, device="cpu", dtype=BF16)
    tm.load_state_dict(convert.speechsr_from_jax(params), strict=True)
    with torch.no_grad():
        port = tm(torch.from_numpy(x))
    assert port.dtype == BF16 and port.shape == (1, 1800, 1)
    _check(_distances(port.float().numpy(), f32, composed, interp))


def test_bf16_builds_keep_float32_parameters():
    """A bf16 build's state_dict is float32 and equal to the float32
    build's of the same seed (the vocoder's training members too); at the
    reference depth it carries through the JAX package's converters and
    back through convert.*_from_jax unchanged (as the float32 round trip of
    tests/test_torch_vocoder.py)."""
    builds = (
        functools.partial(TorchVocoder, **SMALL, device="cpu", train=True, seed=11),
        functools.partial(TorchSR, 16, device="cpu", seed=12),
        functools.partial(TorchMPD, **MPD_SMALL, device="cpu", seed=13))
    for build in builds:
        sd16, sd32 = build(dtype=BF16).state_dict(), build().state_dict()
        assert sd16.keys() == sd32.keys()
        for k, v in sd16.items():
            assert v.dtype == torch.float32, k
            assert torch.equal(v, sd32[k]), k

    sd = TorchVocoder(device="cpu", seed=11, dtype=BF16).state_dict()
    tree = {
        "enc_p_l": jconvert.posterior_sf_encoder(sd, "enc_p_l"),
        "flow_l": convert_ref.dit_coupling_block(sd, "flow_l", 4, 3),
        "flow": convert_ref.dit_coupling_block(sd, "flow", 4, 3),
        "dec": jconvert.generator(sd, "dec", 5),
        "sn": jconvert.source_network(sd, "sn"),
        "emb_g": convert_ref.style_encoder(sd, "emb_g"),
    }
    sr = TorchSR(device="cpu", seed=12, dtype=BF16).state_dict()
    for sd, back in ((sd, convert.vocoder_from_jax(tree)),
                     (sr, convert.speechsr_from_jax(
                         jconvert.convert_speechsr(sr, "")))):
        assert back.keys() == sd.keys()
        for k, v in sd.items():
            assert v.dtype == torch.float32 and torch.equal(back[k], v), k
