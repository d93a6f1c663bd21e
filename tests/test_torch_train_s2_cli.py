"""The s2 and s1 training CLIs of the port on the CPU, on a tiny corpus of
the port's cli/make_synth_corpus, at TTVModel(text_layers=1,
mel_enc_layers=1, w2v_enc_layers=1, w2v_dec_layers=2) and a 1-layer PLM,
batch 2:

  - train_s2: k-means set the codebooks before the first step; 2 steps,
    then a restart for 2 more, end where 4 straight steps end (every
    weight, codebook and u / v within 1e-6 relative); the eval hook's
    scalars are logged;
  - train_s1 from that run's checkpoint directory, and from a
    reference-named .pth state_dict (the frozen TTV is that state_dict);
  - train.dtype "bf16" raises in both;
  - the trained TTV and PLM, loaded into serving builds, serve
    TTSPipeline.tts, whose PLM codes are those of a fresh pack."""
import json
import os

import numpy as np
import pytest
import torch

from megatts2_hierspeechpp_torch.cli import make_synth_corpus
from megatts2_hierspeechpp_torch.cli import train_s1 as cli_s1
from megatts2_hierspeechpp_torch.cli import train_s2 as cli_s2
from megatts2_hierspeechpp_torch.data.dataset import collate
from megatts2_hierspeechpp_torch.infer.pipeline import TTSPipeline
from megatts2_hierspeechpp_torch.models import plm as tplm
from megatts2_hierspeechpp_torch.models.vocoder import HierVocoder
from megatts2_hierspeechpp_torch.train import checkpoints as ckpt_lib
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_vocoder import SMALL as VOC_SMALL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH = dict(text_layers=1, mel_enc_layers=1, w2v_enc_layers=1,
             w2v_dec_layers=2, plm_layers=1)
TEXT = "sil n i3 h ao3 #1 sp sh iii4 j ie4 #4 sil"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("s2corpus"))
    make_synth_corpus.make_corpus(d, n=6, seed=3, holdout=2)
    return d


def small_config(path, corpus_dir, **train):
    with open(os.path.join(REPO, "configs", "config.json")) as f:
        cfg = json.load(f)
    cfg["data"]["training_files"] = os.path.join(corpus_dir, "train_list.txt")
    cfg["data"]["validation_files"] = os.path.join(corpus_dir, "eval_list.txt")
    cfg["model"].update(DEPTH)
    cfg["train"].update(dict(batch_size=2, epochs=1, log_interval=1,
                             save_interval=2, eval_interval=2,
                             eval_plots=False), **train)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)


def scalars(run_dir):
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def s2_runs(corpus, tmp_path_factory):
    """A straight 4-step run ("a") and a 2-step run resumed for 2 ("b")."""
    tmp = tmp_path_factory.mktemp("s2runs")
    logs = str(tmp / "logs")
    cfg2 = small_config(tmp / "c2.json", corpus, epochs=2)
    cfg1 = small_config(tmp / "c1.json", corpus, epochs=1)
    a = cli_s2.main(["-c", cfg2, "-m", "a", "--logs_dir", logs, "--device", "cpu"])
    b1 = cli_s2.main(["-c", cfg1, "-m", "b", "--logs_dir", logs, "--device", "cpu"])
    b1_step = b1.step
    b = cli_s2.main(["-c", cfg2, "-m", "b", "--logs_dir", logs, "--device", "cpu"])
    return logs, cfg2, a, b1_step, b


def test_train_s2_kmeans_restart_and_eval(s2_runs, corpus):
    logs, cfg, a, b1_step, b = s2_runs
    assert (a.step, b1_step, b.step) == (4, 2, 4)
    for sa, sb in ((a.ttv.state_dict(), b.ttv.state_dict()),
                   (a.disc.state_dict(), b.disc.state_dict())):
        assert sa.keys() == sb.keys()
        for k in sa:
            np.testing.assert_allclose(sb[k].numpy(), sa[k].numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    # k-means: the codebook statistics hold the first batch's sample count
    # after 4 EMA steps of decay 0.99 (the seeded build starts at zero
    # counts, and 4 EMA steps alone add 0.01 of a batch's frames each)
    hps = cli_s2.load_hparams(cfg)
    fresh = cli_s2.build_state(hps, "cpu", hps.train.seed, 1).ttv
    ds = cli_s2.SidecarDataset(hps.data.training_files, cli_s2.DatasetConfig())
    sampler = cli_s2.DistributedBucketSampler(
        ds.lengths(), 2, list(cli_s2.BOUNDARIES), seed=hps.train.seed)
    first = collate([ds[i] for i in sampler.epoch_batches(0)[0]], pad_multiple=64)
    n = int(np.ceil(first["mel_lengths"] / 8).sum())
    cb = a.ttv.quantizer.vq.layers[0]._codebook
    assert float(fresh.quantizer.vq.layers[0]._codebook.cluster_size.sum()) == 0.0
    assert float(cb.cluster_size.sum()) > 0.95 * min(n, 500)
    assert not torch.equal(cb.embed, fresh.quantizer.vq.layers[0]._codebook.embed)
    recs = scalars(os.path.join(logs, "a"))
    assert [r["step"] for r in recs if "loss/g/total" in r] == [1, 2, 3, 4]
    evals = [r for r in recs if "eval/w2v_l1" in r]
    assert [r["step"] for r in evals] == [2, 4]
    for r in recs:
        assert all(np.isfinite(v) for v in r.values())
    assert ckpt_lib.latest_step(os.path.join(logs, "b", "ckpt")) == 4


def test_train_s1_from_s2_run_and_from_pth(s2_runs, corpus, tmp_path):
    logs, _, a, _, _ = s2_runs
    cfg = small_config(tmp_path / "c.json", corpus)
    st = cli_s1.main(["-c", cfg, "-m", "s1", "--logs_dir", logs, "--device", "cpu",
                      "--s2_ckpt", os.path.join(logs, "a", "ckpt")])
    assert st.step == 2
    for k, v in a.ttv.state_dict().items():
        assert torch.equal(st.ttv.state_dict()[k], v), k
    recs = scalars(os.path.join(logs, "s1"))
    assert [r["step"] for r in recs if "loss/plm" in r] == [1, 2]
    assert [r["step"] for r in recs if "eval/plm_loss" in r] == [2]
    # a reference-named .pth (the reference checkpoint's "model" entry)
    hps = cli_s2.load_hparams(cfg)
    ref = cli_s2.build_ttv(hps, "cpu", seed=77, train=False)
    pth = str(tmp_path / "G_ttv.pth")
    torch.save({"model": ref.state_dict(), "iteration": 1}, pth)
    st2 = cli_s1.main(["-c", cfg, "-m", "s1_pth", "--logs_dir", logs,
                       "--device", "cpu", "--s2_ckpt", pth])
    assert st2.step == 2
    for k, v in ref.state_dict().items():
        assert torch.equal(st2.ttv.state_dict()[k], v), k


def test_training_clis_refuse_bf16(corpus, tmp_path):
    cfg = small_config(tmp_path / "c.json", corpus, dtype="bf16")
    with pytest.raises(NotImplementedError, match="bf16"):
        cli_s2.main(["-c", cfg, "-m", "x", "--logs_dir", str(tmp_path),
                     "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="bf16"):
        cli_s1.main(["-c", cfg, "-m", "y", "--logs_dir", str(tmp_path),
                     "--device", "cpu", "--s2_ckpt", str(tmp_path)])


def test_trained_models_serve_tts(s2_runs, corpus, tmp_path):
    """The s2 run's TTV and an s1 run's PLM, loaded into serving builds,
    run TTSPipeline.tts; its PLM codes equal a fresh build's decode."""
    logs, _, a, _, _ = s2_runs
    cfg = small_config(tmp_path / "c.json", corpus)
    st = cli_s1.main(["-c", cfg, "-m", "s1_serve", "--logs_dir", logs,
                      "--device", "cpu", "--s2_ckpt", os.path.join(logs, "a", "ckpt")])
    hps = cli_s2.load_hparams(cfg)
    ttv = cli_s2.build_ttv(hps, "cpu", seed=0, train=False)
    ttv.load_state_dict(ckpt_lib.restore_raw(os.path.join(logs, "a", "ckpt"))["ttv"])
    plm = tplm.ProsodyLM(n_layers=1, seed=5, device="cpu")
    plm.load_state_dict(ckpt_lib.restore_raw(
        os.path.join(logs, "s1_serve", "ckpt"))["plm"])
    for k, v in st.plm.state_dict().items():
        assert torch.equal(plm.state_dict()[k], v), k
    pipe = TTSPipeline(HierVocoder(**VOC_SMALL, device="cpu"), None, "cpu",
                       ttv=ttv, plm=plm)
    audio = (np.random.default_rng(8).standard_normal(16000) * 0.1).astype(np.float32)
    wav, ac, _ = pipe.tts(TEXT, audio, exact=True, return_intermediates=True)
    assert wav.shape == (320 * ac.frames,) and np.isfinite(wav).all()
    # the trained PLM (packed after its steps) decodes as a fresh pack does
    st.plm.eval()
    fresh = tplm.ProsodyLM(n_layers=1, seed=6, device="cpu")
    fresh.load_state_dict(st.plm.state_dict())
    np.testing.assert_array_equal(tplm.decode(st.plm, ac.x_frame).numpy(),
                                  ac.codes.numpy().reshape(1, -1))
    np.testing.assert_array_equal(tplm.decode(fresh, ac.x_frame).numpy(),
                                  ac.codes.numpy().reshape(1, -1))
