"""The port's Wav2Vec2 (models/wav2vec2.py) against the JAX Wav2Vec2 on the
CPU, and the weight carry-over in both directions: JAX params ->
wav2vec2_from_jax -> the port, whose state_dict the JAX package's own HF
converter (convert_wav2vec2) turns back into the same params.

Small configuration: hidden 64, 4 heads, FFN 128, conv_dim (32,) x 7,
output_layer 2; the positional conv at kernel 16 / groups 4 (even: HF's
SamePadLayer drops a frame) and kernel 15 / groups 4 (odd). Seeded random
params (LayerNorm scales near 1, biases nonzero). Tolerance: atol 1e-4."""
import numpy as np
import pytest
import torch

import jax

from megatts2_hierspeechpp_torch.convert import wav2vec2_from_jax
from megatts2_hierspeechpp_torch.models.wav2vec2 import Wav2Vec2 as TorchW2V
from megatts2_hierspeechpp_tpu.models.convert import convert_wav2vec2
from megatts2_hierspeechpp_tpu.models.wav2vec2 import Wav2Vec2 as JaxW2V
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_vocoder import _check

SMALL = dict(hidden_size=64, n_heads=4, ffn_dim=128, output_layer=2,
             conv_dim=(32,) * 7)


def random_vars(module, seed, *args, collections=("params",)):
    """Seeded random variables with the structure of module.init(*args)
    (jax.eval_shape: no init compile). Kernels and packed projections
    N(0, 1/fan_in); LayerNorm / norm scales and slopes 1 + N(0, 0.1^2);
    PReLU alphas 0.25 + N(0, 0.05^2); BatchNorm running means N(0, 0.1^2)
    and variances exp(N(0, 0.2^2)); everything else N(0, 0.05^2)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)

    def leaf(path, s):
        name = path[-1].key
        n = rng.standard_normal(s.shape)
        if name == "kernel" or name == "up_kernel":
            v = n / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "in_proj_weight":
            v = n / np.sqrt(s.shape[1])
        elif name in ("scale", "slope"):
            v = 1.0 + 0.1 * n
        elif name == "alpha":
            v = 0.25 + 0.05 * n
        elif name == "mean":
            v = 0.1 * n
        elif name == "var":
            v = np.exp(0.2 * n)
        else:
            v = 0.05 * n
        return v.astype(np.float32)

    return {c: jax.tree_util.tree_map_with_path(leaf, shapes[c])
            for c in collections}


def small_pair(seed, **kw):
    """(JAX module, its params, the port module with the same weights)."""
    jm = JaxW2V(**SMALL, **kw)
    params = random_vars(jm, seed, np.zeros((1, 3200), np.float32))["params"]
    tm = TorchW2V(**SMALL, **kw, device="cpu")
    tm.load_state_dict(wav2vec2_from_jax(params), strict=True)
    return jm, params, tm


@pytest.mark.parametrize("kernel", [16, 15])
def test_wav2vec2_matches_jax(kernel):
    jm, params, tm = small_pair(kernel, pos_conv_kernel=kernel,
                                pos_conv_groups=4)
    x = (np.random.default_rng(1).standard_normal((2, 6480)) * 0.3).astype(
        np.float32)
    want = jax.jit(jm.apply)({"params": params}, x)
    got = tm(torch.from_numpy(x))
    assert got.shape == (2, 6480 // 320, 64) == want.shape
    _check(got, want)


def test_converter_round_trip():
    """The port's state_dict carries the HF names: the JAX package's
    convert_wav2vec2 reads it back into the params it came from (the
    positional conv re-fused from weight_g / weight_v, so to rounding)."""
    _, params, tm = small_pair(3, pos_conv_kernel=16, pos_conv_groups=4)
    back = convert_wav2vec2(tm.state_dict(), output_layer=2)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_allclose(np.asarray(flat_b[path]), np.asarray(a),
                                   atol=1e-6, rtol=1e-6, err_msg=str(path))


def test_full_width_names_and_size():
    """mms-300m widths, 7 layers: about 101 M parameters, every one of them
    under an HF Wav2Vec2Model key that convert_wav2vec2 reads (which fuses
    the positional conv's weight_g, one value per tap, into its kernel)."""
    tm = TorchW2V(device="cpu")
    n = sum(p.numel() for p in tm.parameters())
    assert 100e6 < n < 102e6, n
    params = convert_wav2vec2(tm.state_dict(), output_layer=7)
    n_jax = sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(params))
    assert n_jax == n - 128
