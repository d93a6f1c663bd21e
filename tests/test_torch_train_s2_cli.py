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
  - with no train.dtype both compute in bf16 (float32 parameters), "fp32"
    builds float32, an unknown dtype raises;
  - the trained TTV and PLM, loaded into serving builds, serve
    TTSPipeline.tts, whose PLM codes are those of a fresh pack;
  - infer/from_training.build_pipeline_from_train_dirs over the s2 run, an
    s1 run from it, a cli/train_vocoder run and a SpeechSR .pth: the
    models' state_dicts equal the checkpoints, its tts gives the codes and
    waveform of a build made by hand, and at bf16 compute the bf16 latent
    decodes through the kernel's wrapper."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from megatts2_hierspeechpp_torch.cli import make_synth_corpus
from megatts2_hierspeechpp_torch.cli import train_s1 as cli_s1
from megatts2_hierspeechpp_torch.cli import train_s2 as cli_s2
from megatts2_hierspeechpp_torch.cli import train_vocoder as cli_voc
from megatts2_hierspeechpp_torch.data.dataset import collate
from megatts2_hierspeechpp_torch.infer import from_training
from megatts2_hierspeechpp_torch.infer.pipeline import TTSPipeline
from megatts2_hierspeechpp_torch.models import plm as tplm
from megatts2_hierspeechpp_torch.models.speechsr import SpeechSR
from megatts2_hierspeechpp_torch.models.vocoder import (
    HierVocoder,
    serving_state_dict,
)
from megatts2_hierspeechpp_torch.train import checkpoints as ckpt_lib
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_train_loop import _small_config as voc_config
from tests.test_torch_vocoder import SMALL as VOC_SMALL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH = dict(text_layers=1, mel_enc_layers=1, w2v_enc_layers=1,
             w2v_dec_layers=2, plm_layers=1)
TEXT = "sil n i3 h ao3 #1 sp sh iii4 j ie4 #4 sil"


@pytest.fixture(autouse=True)
def _remove_run_dirs(tmp_path):
    """Each test's run directories (checkpoints at published widths) are
    removed once its asserts have run: a whole Tier-1 run would otherwise
    fill a small /tmp."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("s2corpus"))
    make_synth_corpus.make_corpus(d, n=6, seed=3, holdout=2)
    yield d
    shutil.rmtree(d, ignore_errors=True)


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
    yield logs, cfg2, a, b1_step, b
    shutil.rmtree(tmp, ignore_errors=True)  # the runs' checkpoints, 2.3 GB


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


def test_training_clis_take_bf16(corpus, tmp_path):
    """With no train.dtype both CLIs run one step in bf16 compute (float32
    parameters), as the JAX CLIs; "fp32" builds float32; "fp16" raises."""
    cfg = small_config(tmp_path / "c.json", corpus, epochs=1, batch_size=4)
    hps = cli_s2.load_hparams(cfg)
    assert "dtype" not in hps.train
    logs = str(tmp_path / "logs")
    s2 = cli_s2.main(["-c", cfg, "-m", "s2", "--logs_dir", logs, "--device", "cpu"])
    assert s2.step == 1
    s1 = cli_s1.main(["-c", cfg, "-m", "s1", "--logs_dir", logs, "--device", "cpu",
                      "--s2_ckpt", os.path.join(logs, "s2", "ckpt")])
    assert s1.step == 1
    for mod in (s2.ttv, s2.ttv.w2v_decoder.proj, s2.ttv.duration_predictor.proj,
                s2.disc.discriminators[0].out, s1.ttv, s1.plm.predict_layer,
                s1.plm.plm.layers[0].attn.w_q):
        assert mod.dtype == torch.bfloat16, mod
    params = [*s2.ttv.parameters(), *s2.disc.parameters(), *s1.plm.parameters()]
    assert all(p.dtype == torch.float32 for p in params)
    with torch.no_grad():
        x_frame, _ = s1.ttv.extract_tc_latent_code(*(
            torch.from_numpy(v) for v in _first_batch(hps, 4)))
    assert x_frame.dtype == torch.bfloat16

    fp32 = cli_s2.load_hparams(small_config(tmp_path / "f.json", corpus,
                                            dtype="fp32"))
    st = cli_s2.build_state(fp32, "cpu", fp32.train.seed, 1)
    assert st.ttv.dtype is None and st.disc.discriminators[0].out.dtype is None
    assert cli_s1.build_state(fp32, "cpu", st.ttv).plm.predict_layer.dtype is None

    bad = small_config(tmp_path / "b.json", corpus, dtype="fp16")
    with pytest.raises(ValueError, match="fp16"):
        cli_s2.main(["-c", bad, "-m", "x", "--logs_dir", logs, "--device", "cpu"])
    with pytest.raises(ValueError, match="fp16"):
        cli_s1.main(["-c", bad, "-m", "y", "--logs_dir", logs, "--device", "cpu",
                     "--s2_ckpt", os.path.join(logs, "s2", "ckpt")])
    shutil.rmtree(logs)   # the runs' checkpoints, about 0.4 GB


def _first_batch(hps, b):
    """The extract_tc_latent_code inputs of the first batch of a config."""
    ds = cli_s2.SidecarDataset(hps.data.training_files, cli_s2.DatasetConfig())
    sampler = cli_s2.DistributedBucketSampler(
        ds.lengths(), b, list(cli_s2.BOUNDARIES), seed=hps.train.seed)
    first = collate([ds[i] for i in sampler.epoch_batches(0)[0]], pad_multiple=64)
    return [first[k] for k in ("x_ids", "tone", "language", "x_lengths", "mel",
                                "mel_lengths", "dur", "mrte_mel",
                                "mrte_mel_lengths")]


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


@pytest.fixture(scope="module")
def train_dirs(s2_runs, corpus, tmp_path_factory):
    """(s2 run, s1 run, vocoder run, SpeechSR .pth) directories / files."""
    logs, _, _, _, _ = s2_runs
    tmp = tmp_path_factory.mktemp("runs")
    cfg = small_config(tmp / "c.json", corpus)
    cli_s1.main(["-c", cfg, "-m", "s1_ft", "--logs_dir", logs, "--device", "cpu",
                 "--s2_ckpt", os.path.join(logs, "a", "ckpt")])
    vcfg = voc_config(tmp / "v.json", corpus, dtype="fp32")
    cli_voc.main(["-c", vcfg, "-m", "voc", "--logs_dir", logs, "--device", "cpu"])
    sr = SpeechSR(8, 3, 1, seed=21, device="cpu").state_dict()
    pth = str(tmp / "sr.pth")
    torch.save({"model": {f"dec.{k}": v for k, v in sr.items()}}, pth)
    yield (os.path.join(logs, "a"), os.path.join(logs, "s1_ft"),
           os.path.join(logs, "voc"), pth)
    shutil.rmtree(tmp, ignore_errors=True)


def test_pipeline_from_train_dirs(train_dirs):
    s2_dir, s1_dir, voc_dir, sr_pth = train_dirs
    pipe = from_training.build_pipeline_from_train_dirs(
        s2_dir, s1_dir, voc_dir, speechsr=sr_pth, device="cpu")
    raw = {d: ckpt_lib.restore_raw(os.path.join(d, "ckpt"))
           for d in (s2_dir, s1_dir, voc_dir)}
    for module, sd in ((pipe.ttv, raw[s2_dir]["ttv"]), (pipe.plm, raw[s1_dir]["plm"]),
                       (pipe.vocoder, serving_state_dict(raw[voc_dir]["gen"]))):
        got = module.state_dict()
        assert got.keys() == sd.keys()
        assert all(torch.equal(got[k], v) for k, v in sd.items())
    assert pipe.ttv.dtype is None and len(pipe.plm.plm.layers) == 1
    assert pipe.speechsr.conv_pre.weight_v.shape[0] == 8

    # a build by hand from the same checkpoints serves the same request
    hps = cli_s2.load_hparams(os.path.join(s2_dir, "config.json"))
    ttv = cli_s2.build_ttv(hps, "cpu", seed=3, train=False)
    ttv.load_state_dict(raw[s2_dir]["ttv"])
    plm = tplm.ProsodyLM(n_layers=1, seed=4, device="cpu")
    plm.load_state_dict(raw[s1_dir]["plm"])
    voc = HierVocoder(**VOC_SMALL, device="cpu")
    voc.load_state_dict(serving_state_dict(raw[voc_dir]["gen"]))
    hand = TTSPipeline(voc, None, "cpu", ttv=ttv, plm=plm)
    audio = (np.random.default_rng(8).standard_normal(16000) * 0.1).astype(np.float32)
    got = pipe.tts(TEXT, audio, exact=True, return_intermediates=True)
    want = hand.tts(TEXT, audio, exact=True, return_intermediates=True)
    assert torch.equal(got[1].codes, want[1].codes)
    np.testing.assert_array_equal(got[0], want[0])
    # served in bf16 compute: the bf16 latent decodes through the kernel's
    # wrapper (float32 inside) to valid codes
    pipe16 = from_training.build_pipeline_from_train_dirs(
        s2_dir, s1_dir, voc_dir, dtype=torch.bfloat16, device="cpu")
    assert all(p.dtype == torch.float32 for p in pipe16.ttv.parameters())
    wav, ac, _ = pipe16.tts(TEXT, audio, exact=True, return_intermediates=True)
    assert ac.x_frame.dtype == torch.bfloat16 and np.isfinite(wav).all()
    assert torch.equal(ac.codes.reshape(1, -1),
                       tplm.decode(pipe16.plm, ac.x_frame.float()))
