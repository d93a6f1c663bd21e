"""The port's HierVocoder.voice_conversion (the serving path's vocode
stage) against the JAX method on the CPU, with rng=None and the style
interpolated between the two prompt rows at denoise_ratio 0 and 0.5.

The test_torch_vocoder.py configuration and params. Tolerance: atol 1e-4."""
import numpy as np
import pytest
import torch

import jax

from megatts2_hierspeechpp_tpu.models.vocoder import HierVocoder as JaxVocoder
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_vocoder import _check, _inputs, vocoders  # noqa: F401


@pytest.fixture(scope="module")
def jax_vc(vocoders):
    """The JAX voice_conversion, jitted once with denoise_ratio traced."""
    jm = vocoders[0]
    return jax.jit(lambda p, *a, dr: jm.apply(
        {"params": p}, *a, 0.333, None, dr,
        method=JaxVocoder.voice_conversion))


@pytest.mark.parametrize("denoise_ratio", [0.0, 0.5])
def test_voice_conversion_matches_jax(vocoders, jax_vc, denoise_ratio):
    _, params, tm = vocoders
    _, w2v, mask, f0 = _inputs(seed=6)
    trg_mel = np.random.default_rng(7).standard_normal((2, 24, 80)).astype(
        np.float32)
    trg_mask = np.ones((2, 24, 1), np.float32)
    want = jax_vc(params, w2v, mask, trg_mel, trg_mask, f0,
                  dr=np.float32(denoise_ratio))
    got = tm.voice_conversion(*map(torch.from_numpy,
                                   (w2v, mask, trg_mel, trg_mask, f0)),
                              0.333, None, denoise_ratio)
    _check(got, want)


def test_style_pairs_and_split_decode(vocoders):
    """style_pairs against the JAX method; vc_latent + decode_latent is
    voice_conversion split at the Generator."""
    jm, params, tm = vocoders
    mel = np.random.default_rng(8).standard_normal((4, 20, 80)).astype(
        np.float32)
    mask = np.ones((4, 20, 1), np.float32)
    want = jax.jit(lambda p, *a: jm.apply(
        {"params": p}, *a, method=JaxVocoder.style_pairs))(params, mel, mask)
    got = tm.style_pairs(torch.from_numpy(mel), torch.from_numpy(mask))
    assert got.shape == (2, 2, 256)
    _check(got, want)

    _, w2v, src_mask, f0 = _inputs(seed=9)
    args = [torch.from_numpy(a) for a in (w2v, src_mask, mel[:2], mask[:2], f0)]
    z, e, g = tm.vc_latent(*args, 0.333, torch.Generator().manual_seed(3), 0.2)
    split = tm.decode_latent(z, e, g)
    whole = tm.voice_conversion(*args, 0.333, torch.Generator().manual_seed(3),
                                0.2)
    assert torch.equal(split, whole)

