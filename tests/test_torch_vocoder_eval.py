"""The vocoder trainer's eval hook (train/evalhooks.make_vocoder_eval_fn)
against the JAX package's on the CPU, and cli/train_vocoder running it.

Small configuration (as tests/test_torch_train_step.py): HierVocoder
(upsample_initial_channel 64, posterior_wn_layers 4, n_flows 1,
flow_layers 1), B = 2 utterances of 16 and 13 frames, a seeded JAX tree
carried over by convert.vocoder_from_jax. The hook synthesises with the
inference path and no noise (z = m x mask). Tolerance: mel_l1 within 1e-4
relative (a mean over the log-mels of the two waveforms, which agree
within the modules' 1e-4)."""
import json
import os
import shutil

import numpy as np
import pytest

from megatts2_hierspeechpp_torch.cli import make_synth_corpus as tcorpus
from megatts2_hierspeechpp_torch.cli import train_vocoder as tcli
from megatts2_hierspeechpp_torch.convert import vocoder_from_jax
from megatts2_hierspeechpp_torch.models.vocoder import HierVocoder as TorchVocoder
from megatts2_hierspeechpp_torch.train import evalhooks as tev
from megatts2_hierspeechpp_tpu.train import evalhooks as jev
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_train_loop import _small_config
from tests.test_torch_train_modules import SMALL, jax_vocoder_params
from tests.test_torch_train_step import step_batch


@pytest.fixture(autouse=True)
def _remove_run_dirs(tmp_path):
    """Each test's run directories (checkpoints at published widths) are
    removed once its asserts have run: a whole Tier-1 run would otherwise
    fill a small /tmp."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_vocoder_eval_fn_matches_jax(tmp_path):
    jm, params = jax_vocoder_params(seed=70)
    batch = step_batch(seed=71)
    want = jev.make_vocoder_eval_fn(jm, batch, plot=False)(
        type("S", (), {"params_g": params}), 1, str(tmp_path))
    gen = TorchVocoder(**SMALL, device="cpu", train=True)
    gen.load_state_dict(vocoder_from_jax(params), strict=True)
    got = tev.make_vocoder_eval_fn(batch)(type("S", (), {"gen": gen}), 5,
                                         str(tmp_path))
    assert got.keys() == want.keys() == {"mel_l1"}
    np.testing.assert_allclose(got["mel_l1"], want["mel_l1"], rtol=1e-4)
    assert os.listdir(tmp_path / "eval") == ["excitation_5.png"]
    assert all(p.requires_grad for p in gen.parameters())   # left trainable


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("corpus"))
    tcorpus.make_corpus(d, n=4, seed=5)
    return d


def test_train_vocoder_cli_logs_eval(corpus, tmp_path):
    """train.eval_interval 2: eval/mel_l1 at step 2, finite, with its PNG
    (float32 compute)."""
    cfg = _small_config(tmp_path / "cfg.json", corpus, eval_interval=2,
                        dtype="fp32")
    logs = str(tmp_path / "logs")
    state = tcli.main(["-c", cfg, "-m", "run", "--logs_dir", logs,
                       "--device", "cpu"])
    assert state.step == 2
    with open(os.path.join(logs, "run", "scalars.jsonl")) as f:
        evals = [r for r in map(json.loads, f) if "eval/mel_l1" in r]
    assert [r["step"] for r in evals] == [2]
    assert np.isfinite(evals[0]["eval/mel_l1"])
    assert os.listdir(os.path.join(logs, "run", "eval")) == ["excitation_2.png"]
