"""The port's training plumbing on the CPU: AdamW and its per-epoch decay
against optax, checkpoints, the loop's resume and prefetch, the synthetic
corpus against the JAX package's, and cli/train_vocoder end to end at the
small configuration (see test_torch_train_modules.py): in float32 with the
trained generator served afterwards, and at its default bf16 compute with
a resumed run.

Tolerances: AdamW parameters within 1e-6 of optax's after 3 updates (atol,
unit-scale parameters); a resumed run's losses equal the straight run's to
rtol 1e-6 (the same float32 arithmetic on the same draws); the corpus's
wavs, durations, f0 and filelist exactly, its mels and w2v features within
1e-5 of the largest value (the log-mel of two FFT libraries)."""
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from megatts2_hierspeechpp_torch.cli import make_synth_corpus as tcorpus
from megatts2_hierspeechpp_torch.cli import train_vocoder as tcli
from megatts2_hierspeechpp_torch.models.discriminators import (
    MultiPeriodDiscriminator,
)
from megatts2_hierspeechpp_torch.models.vocoder import (
    HierVocoder,
    serving_state_dict,
)
from megatts2_hierspeechpp_torch.train import checkpoints as ckpt
from megatts2_hierspeechpp_torch.train import vocoder as vt
from megatts2_hierspeechpp_torch.train.loop import prefetch, run_training
from megatts2_hierspeechpp_torch.train.optim import AdamW
from megatts2_hierspeechpp_tpu.cli import make_synth_corpus as jcorpus
from megatts2_hierspeechpp_tpu.train.optim import adamw as jadamw
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_train_modules import MPD_SMALL, SMALL

REPO = Path(__file__).resolve().parents[1]


# ---- optimizer ----

@pytest.fixture(autouse=True)
def _remove_run_dirs(tmp_path):
    """Each test's run directories (checkpoints at published widths) are
    removed once its asserts have run: a whole Tier-1 run would otherwise
    fill a small /tmp."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("clip", [None, 0.5])
def test_adamw_with_decay_matches_optax(clip):
    """3 updates with steps_per_epoch 2 (the decay steps in at the third),
    weight decay 0.01, with and without the global-norm clip."""
    rng = np.random.default_rng(40)
    shapes = [(3, 4), (5,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    kw = dict(lr=0.1, betas=(0.8, 0.99), eps=1e-9, weight_decay=0.01,
              lr_decay=0.5, steps_per_epoch=2, max_grad_norm=clip)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = AdamW(tparams, **kw)
    tx = jadamw(**kw)
    jparams = [jnp.asarray(p) for p in params]
    jstate = tx.init(jparams)
    for g in grads:
        for p, gi in zip(tparams, g):
            p.grad = torch.from_numpy(gi.copy())
        opt.step()
        upd, jstate = tx.update([jnp.asarray(gi) for gi in g], jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
    assert opt.count == 3
    for p, w in zip(tparams, jparams):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)


# ---- checkpoints ----

class Holder:
    def __init__(self, **tensors):
        self.tensors = tensors

    def state_dict(self):
        return dict(self.tensors)

    def load_state_dict(self, sd):
        self.tensors = dict(sd)


def test_checkpoint_roundtrip_and_latest(tmp_path):
    base = str(tmp_path / "ckpt")
    s7 = Holder(w=torch.arange(12.0).reshape(3, 4), step=7)
    s20 = Holder(w=torch.arange(12.0).reshape(3, 4) * 2, step=20)
    ckpt.save(base, s7, 7)
    ckpt.save(base, s20, 20)
    assert ckpt.latest_step(base) == 20
    assert torch.equal(ckpt.restore(base, Holder()).tensors["w"], s20.tensors["w"])
    assert ckpt.restore(base, Holder(), step=7).tensors["step"] == 7
    assert ckpt.restore_raw(base)["step"] == 20
    assert sorted(os.listdir(base)) == ["step_00000007", "step_00000020"]


def test_retention_keeps_three(tmp_path):
    base = str(tmp_path / "ckpt")
    for s in range(1, 6):
        ckpt.save(base, Holder(x=torch.ones(2) * s), s)
    assert sorted(os.listdir(base)) == [f"step_{s:08d}" for s in (3, 4, 5)]
    assert ckpt.restore(base, Holder(), step=1) is None


def test_restore_missing_returns_none(tmp_path):
    assert ckpt.restore(str(tmp_path / "nope"), Holder()) is None
    assert ckpt.restore_raw(str(tmp_path / "nope")) is None
    assert ckpt.latest_step(str(tmp_path / "nope")) is None


# ---- loop ----

def test_prefetch_reraises_producer_errors():
    def bad_iter():
        yield 1
        yield 2
        raise FileNotFoundError("corrupt.hw2v.npy")

    got = []
    with pytest.raises(FileNotFoundError, match="corrupt"):
        for item in prefetch(bad_iter(), size=2):
            got.append(item)
    assert got == [1, 2]
    assert list(prefetch(iter(range(5)), size=2)) == list(range(5))


def _small_state(seed=0):
    gen = HierVocoder(**SMALL, device="cpu", train=True, seed=seed)
    disc = MultiPeriodDiscriminator(**MPD_SMALL, device="cpu", seed=seed + 1)
    return vt.create_state(gen, disc, lr=1e-4, steps_per_epoch=10)


def _loop_batches(_epoch):
    """Two batches per epoch: B = 1, 16 frames."""
    for seed in (50, 51):
        rng = np.random.default_rng(seed)
        yield {"spec": torch.from_numpy(np.abs(rng.standard_normal((1, 16, 641))).astype(np.float32)),
               "audio": torch.from_numpy(rng.uniform(-0.5, 0.5, (1, 5120)).astype(np.float32)),
               "mel": torch.from_numpy(rng.standard_normal((1, 16, 80)).astype(np.float32)),
               "w2v": torch.from_numpy(rng.standard_normal((1, 16, 1024)).astype(np.float32)),
               "f0": torch.from_numpy(rng.uniform(0, 250, (1, 64)).astype(np.float32)),
               "mask": torch.ones(1, 16, 1), "lengths": torch.tensor([16])}


def _scalars(model_dir):
    with open(os.path.join(model_dir, "scalars.jsonl")) as f:
        return {r["step"]: r for r in map(json.loads, f)}


def test_resume_reproduces_loss_curve(tmp_path):
    """4 steps straight against 2 steps, a restart from the epoch-end
    checkpoint into a fresh state, and 2 more: the same losses at every
    step (the per-step generators replay the same draws)."""
    step = vt.TrainStep(segment_frames=8)
    kw = dict(log_interval=1, save_interval=100, seed=3)
    dir_a, dir_b = str(tmp_path / "a"), str(tmp_path / "b")
    run_training(_small_state(), step, _loop_batches, dir_a, epochs=2, **kw)
    run_training(_small_state(), step, _loop_batches, dir_b, epochs=1, **kw)
    assert ckpt.latest_step(os.path.join(dir_b, "ckpt")) == 2
    restored = ckpt.restore(os.path.join(dir_b, "ckpt"), _small_state())
    assert restored.step == 2
    run_training(restored, step, _loop_batches, dir_b, epochs=2, start_epoch=1,
                 **kw)
    a, b = _scalars(dir_a), _scalars(dir_b)
    assert set(a) == set(b) == {1, 2, 3, 4}
    for s in a:
        for k, v in a[s].items():
            if k.startswith("loss/"):
                np.testing.assert_allclose(b[s][k], v, rtol=1e-6,
                                           err_msg=f"step {s} {k}")


# ---- corpus and CLI ----

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The port's corpus (4 utterances, seed 5) and the JAX CLI's."""
    tdir = str(tmp_path_factory.mktemp("corpus_torch"))
    jdir = str(tmp_path_factory.mktemp("corpus_jax"))
    tcorpus.make_corpus(tdir, n=4, seed=5)
    argv = sys.argv
    sys.argv = ["make_synth_corpus", "--out_dir", jdir, "--n", "4", "--seed", "5"]
    try:
        jcorpus.main()
    finally:
        sys.argv = argv
    return tdir, jdir


def test_synth_corpus_matches_jax(corpus):
    from scipy.io import wavfile

    tdir, jdir = corpus
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir))
    for name in ("trans.txt", "2-name2text.txt", "6-name2semantic.tsv"):
        with open(os.path.join(tdir, name)) as ft, open(os.path.join(jdir, name)) as fj:
            assert ft.read().replace(tdir, "D") == fj.read().replace(jdir, "D"), name
    for i in range(4):
        base = f"utt{i:04d}"
        wt = wavfile.read(os.path.join(tdir, base + ".wav"))[1]
        wj = wavfile.read(os.path.join(jdir, base + ".wav"))[1]
        assert np.array_equal(wt, wj)
        for suffix in (".dur.npy", ".hf0.npy"):
            assert np.array_equal(np.load(os.path.join(tdir, base + suffix)),
                                  np.load(os.path.join(jdir, base + suffix)))
        for suffix in (".hmel.npy", ".hw2v.npy"):
            t = np.load(os.path.join(tdir, base + suffix))
            j = np.load(os.path.join(jdir, base + suffix))
            assert t.shape == j.shape
            assert np.abs(t - j).max() <= 1e-5 * np.abs(j).max(), suffix


def _small_config(path, corpus_dir, **train):
    with open(REPO / "configs" / "hierspeechpp.json") as f:
        cfg = json.load(f)
    cfg["data"]["training_files"] = os.path.join(corpus_dir, "train_list.txt")
    cfg["model"].update(upsample_initial_channel=64, posterior_wn_layers=4,
                        n_flows=1, flow_layers=1,
                        mpd_resolutions=[list(r) for r in MPD_SMALL["resolutions"]],
                        mpd_periods=list(MPD_SMALL["periods"]))
    cfg["train"].update(dict(batch_size=2, epochs=1, log_interval=1,
                             save_interval=2, segment_frames=8), **train)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)


def test_train_vocoder_cli_then_serve(corpus, tmp_path):
    """cli/train_vocoder.main with train.dtype "fp32" takes 2 steps in
    float32 on the port's corpus and writes a checkpoint; the trained
    generator, without its training-only members, loads into a serving
    HierVocoder whose forward runs."""
    tdir, _ = corpus
    cfg = _small_config(tmp_path / "cfg.json", tdir, dtype="fp32")
    logs = str(tmp_path / "logs")
    state = tcli.main(["-c", cfg, "-m", "run", "--logs_dir", logs,
                       "--device", "cpu"])
    assert state.step == 2
    assert state.gen.dtype is None
    recs = _scalars(os.path.join(logs, "run"))
    assert set(recs) == {1, 2}
    for r in recs.values():
        assert all(np.isfinite(v) for k, v in r.items() if k.startswith("loss/"))
    saved = ckpt.restore_raw(os.path.join(logs, "run", "ckpt"))
    assert saved["step"] == 2
    serving = HierVocoder(**SMALL, device="cpu")
    serving.load_state_dict(serving_state_dict(saved["gen"]), strict=True)
    rng = np.random.default_rng(60)
    t = 12
    with torch.no_grad():
        wav, e_ = serving(torch.randn(1, t, 80), torch.randn(1, t, 1024),
                          torch.ones(1, t, 1),
                          torch.from_numpy(np.log1p(rng.uniform(0, 250, (1, 4 * t, 1)))).float())
    assert wav.shape == (1, 320 * t, 1) and torch.isfinite(wav).all()


def test_train_vocoder_cli_trains_bf16_by_default(corpus, tmp_path):
    """With no train.dtype the CLI computes in bf16, as the JAX CLI: 2
    steps, a checkpoint, then 2 steps resumed from it, every loss finite;
    the models compute in bf16 while the parameters (and so the
    checkpoint) stay float32."""
    tdir, _ = corpus
    logs = str(tmp_path / "logs")
    for epochs, steps in ((1, 2), (2, 4)):
        cfg = _small_config(tmp_path / f"cfg{epochs}.json", tdir, epochs=epochs)
        assert "dtype" not in json.load(open(cfg))["train"]
        state = tcli.main(["-c", cfg, "-m", "run", "--logs_dir", logs,
                           "--device", "cpu"])
        assert state.step == steps
        assert ckpt.latest_step(os.path.join(logs, "run", "ckpt")) == steps
    assert state.gen.dtype == torch.bfloat16
    assert state.disc.discriminators[0].convs[0].dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in state.gen.parameters())
    recs = _scalars(os.path.join(logs, "run"))
    assert set(recs) == {1, 2, 3, 4}
    for r in recs.values():
        assert all(np.isfinite(v) for k, v in r.items() if k.startswith("loss/"))
    saved = ckpt.restore_raw(os.path.join(logs, "run", "ckpt"))
    assert all(v.dtype == torch.float32 for v in saved["gen"].values()
               if v.is_floating_point())


def test_train_vocoder_unknown_dtype_raises(corpus, tmp_path):
    tdir, _ = corpus
    cfg = _small_config(tmp_path / "cfg.json", tdir, dtype="fp16")
    with pytest.raises(ValueError, match="fp16"):
        tcli.main(["-c", cfg, "-m", "run", "--logs_dir", str(tmp_path / "logs"),
                   "--device", "cpu"])
