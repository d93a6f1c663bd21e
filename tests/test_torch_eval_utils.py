"""The port's evaluation and observability utilities against the JAX
package's on the CPU: eval/compare.py (mel_l1 at 16 / 24 / 48 kHz within
1e-4 relative of JAX's, waveform_metrics exactly, the CLI on two files of
different rates), utils/flops.py (count_flops of a matmul, a conv, a
transposed conv exactly JAX's count, the small HierVocoder forward within
1 % of JAX's jaxpr walk) and utils/profiling.py (trace writing a Chrome
trace that names an annotated span with its args)."""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megatts2_hierspeechpp_torch.eval import compare as tcompare
from megatts2_hierspeechpp_torch.models.vocoder import HierVocoder as TorchVocoder
from megatts2_hierspeechpp_torch.utils import profiling as tprof
from megatts2_hierspeechpp_torch.utils.flops import count_flops
from megatts2_hierspeechpp_tpu.eval import compare as jcompare
from megatts2_hierspeechpp_tpu.models.vocoder import HierVocoder as JaxVocoder
from megatts2_hierspeechpp_tpu.utils.flops import count_flops as jax_count_flops
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_vocoder import SMALL, _inputs, random_params


def _tone(sr, seconds=1.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            + 0.05 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.mark.parametrize("sr", [16000, 24000, 48000])
def test_mel_l1_matches_jax(sr):
    a, b = _tone(sr, seed=1), _tone(sr, seed=2)[: int(0.9 * sr)]
    got = tcompare.mel_l1(a, b, sr=sr, device="cpu")
    want = jcompare.mel_l1(a, b, sr=sr)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert tcompare.mel_l1(a, a, sr=sr, device="cpu") == 0.0
    with pytest.raises(ValueError, match="unsupported rate"):
        tcompare.mel_l1(a, b, sr=12345, device="cpu")


def test_waveform_metrics_equal_jax():
    a, b = _tone(16000, seed=3), _tone(16000, seed=4)
    assert tcompare.waveform_metrics(a, b) == jcompare.waveform_metrics(a, b)
    assert tcompare.waveform_metrics(a, a)["max_abs_diff"] == 0


def test_compare_cli_resamples_the_lower_rate(tmp_path):
    """16 kHz against 48 kHz: the 16 kHz file is taken up to 48 kHz with
    the anti-aliased resampler, as the JAX CLI does, before both metrics."""
    from scipy.io import wavfile

    from megatts2_hierspeechpp_tpu.ops.resample import upsample1d

    lo = _tone(16000, seed=5)
    hi = _tone(48000, seed=6)
    for name, sr, w in (("lo.wav", 16000, lo), ("hi.wav", 48000, hi)):
        wavfile.write(tmp_path / name, sr, (w * 32767).astype(np.int16))
    got = tcompare.main([str(tmp_path / "lo.wav"), str(tmp_path / "hi.wav"),
                         "--device", "cpu"])
    lo_i = wavfile.read(tmp_path / "lo.wav")[1].astype(np.float32) / 32768.0
    hi_i = wavfile.read(tmp_path / "hi.wav")[1].astype(np.float32) / 32768.0
    up = np.asarray(upsample1d(jnp.asarray(lo_i)[None, :, None], ratio=3))[0, :, 0]
    want = {"mel_l1": jcompare.mel_l1(up, hi_i, sr=48000)}
    want.update(jcompare.waveform_metrics(up, hi_i))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-6, err_msg=k)


def test_count_flops_matmul_and_convs_equal_jax():
    a, b = np.zeros((4, 128, 256), np.float32), np.zeros((256, 512), np.float32)
    want = jax_count_flops(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
    lin = torch.nn.Linear(256, 512, bias=False)
    assert count_flops(lin, torch.from_numpy(a)) == want == 2 * 4 * 128 * 512 * 256

    x, k = jnp.zeros((2, 100, 64)), jnp.zeros((5, 64, 128))
    dn = jax.lax.conv_dimension_numbers(x.shape, k.shape, ("NWC", "WIO", "NWC"))
    want = jax_count_flops(lambda x, k: jax.lax.conv_general_dilated(
        x, k, (1,), "SAME", dimension_numbers=dn), x, k)
    got = count_flops(torch.nn.Conv1d(64, 128, 5, padding=2), torch.zeros(2, 64, 100))
    assert got == want

    # a transposed conv counts its nonzero taps only, as the JAX walk does
    x, k = jnp.zeros((2, 100, 64)), jnp.zeros((8, 64, 32))
    dn = jax.lax.conv_dimension_numbers(x.shape, k.shape, ("NWC", "WIO", "NWC"))
    want = jax_count_flops(lambda x, k: jax.lax.conv_general_dilated(
        x, k, (1,), [(5, 5)], lhs_dilation=(4,), dimension_numbers=dn), x, k)
    tconv = torch.nn.ConvTranspose1d(64, 32, 8, stride=4, padding=2)
    assert count_flops(tconv, torch.zeros(2, 64, 100)) == want


def test_count_flops_of_the_small_vocoder_near_jax():
    jm = JaxVocoder(**SMALL)
    inputs = _inputs()
    params = random_params(jm, 1, *inputs)
    want = jax_count_flops(lambda p, *a: jm.apply({"params": p}, *a),
                           params, *map(jnp.asarray, inputs))
    tm = TorchVocoder(**SMALL, device="cpu")
    got = count_flops(tm, *map(torch.from_numpy, inputs))
    assert abs(got - want) <= 0.01 * want, (got, want)


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path)) as prof:
        with tprof.annotate("pipeline.call"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        with tprof.annotate("server.call", [7, 8], lambda ids: f"ids={ids}"):
            pass
    path = tmp_path / "trace.json"
    assert path.exists() and os.path.getsize(path) > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "pipeline.call" for e in events)
    assert any(e.get("name") == "server.call"
               and e.get("args", {}).get("args") == "ids=[7, 8]" for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
