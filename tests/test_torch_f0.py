"""The port's YIN f0 tracker (ops/f0.py) against the JAX yin_f0 on the CPU,
on the signals of test_f0.py at B = 2: constant pitches, a pitch glide,
silence and noise.

Tolerances: voicing (f0 > 0) agrees on at least 99 % of frames; where both
are voiced, f0 within 1e-4 relative. Both take their FFTs in float32 with
different libraries, so a frame whose CMNDF sits at the voicing threshold
may flip; none does on these signals."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from megatts2_hierspeechpp_torch.ops.f0 import log_f0_plus1, yin_f0
from megatts2_hierspeechpp_tpu.ops import f0 as jf0
from tests.test_f0 import _harmonic
from tests.test_torch_kernels import few_torch_threads  # noqa: F401


N = 15999  # the glide's length: 3 pieces of 16000 // 3 samples


def _batch(name):
    """(2, N): two of test_f0.py's signals."""
    const = {f: _harmonic([f])[0][:N] for f in (80.0, 150.0, 220.0, 440.0)}
    glide = _harmonic([120.0, 200.0, 160.0])[0]
    noise = np.random.default_rng(0).standard_normal(N).astype(np.float32) * 0.1
    return np.stack({"80_150": [const[80.0], const[150.0]],
                     "220_440": [const[220.0], const[440.0]],
                     "glide_noise": [glide, noise],
                     "silence_glide": [np.zeros(N, np.float32), glide]}[name])


def check_f0(got, want, agree=0.99, rtol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert ((got > 0) == (want > 0)).mean() >= agree
    both = (got > 0) & (want > 0)
    np.testing.assert_allclose(got[both], want[both], rtol=rtol, atol=0)


@pytest.mark.parametrize("name", ["80_150", "220_440", "glide_noise",
                                  "silence_glide"])
def test_yin_f0_matches_jax(name):
    x = _batch(name)
    want = np.asarray(jf0.yin_f0(jnp.asarray(x)))
    got = yin_f0(torch.from_numpy(x))
    assert got.shape == (2, N // 80)
    check_f0(got, want)
    voiced = (want > 0).mean(axis=1)
    if name == "silence_glide":
        assert voiced[0] == 0 and voiced[1] > 0.9
    elif name != "glide_noise":
        assert (voiced > 0.9).all()


def test_shape_contract_and_log_f0():
    """T // hop frames for a length that is no multiple of the hop;
    log(f0 + 1) as the JAX function."""
    x = np.stack([_harmonic([150.0])[0][:3237], _harmonic([95.0])[0][:3237]])
    got = yin_f0(torch.from_numpy(x))
    want = np.asarray(jf0.yin_f0(jnp.asarray(x)))
    assert got.shape == (2, 3237 // 80)
    check_f0(got, want)
    np.testing.assert_allclose(log_f0_plus1(got).numpy(),
                               np.asarray(jf0.log_f0_plus1(jnp.asarray(want))),
                               atol=1e-5, rtol=0)
