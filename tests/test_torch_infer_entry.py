"""The port's serving entry points on the CPU.

  - The reference-checkpoint loaders at the published widths: files in the
    reference's layout, written from seeded port modules (a TTV whose LSTMs
    carry both biases and a key the JAX converter ignores; the PLM; a
    vocoder training build, training-only members included; SpeechSR-48k
    under `dec.` beside another member; the denoiser as {"generator": sd};
    the mms-300m wav2vec2 in HF names with one layer past the seventh and
    the pre-training heads, with and without the `wav2vec2.` prefix, under
    both weight-norm spellings). Each JAX `convert_*` turns a file into a
    JAX tree; the port's `*_from_jax` of it must equal, exactly, the
    state_dict that build_pipeline_from_reference_ckpts (or load_wav2vec2,
    the infer_vc / extract_features loader) loaded from the same file.
  - The four CLIs in-process with --device cpu at the published widths,
    on one short line of about 1 s of audio or 1 s files: infer_tts at 16
    kHz, plain and with --stream, infer_sr, infer_vc and extract_features
    on two files; every written wav equals, as int16, the in-process API
    call on the same inputs, and every sidecar the port's feature calls.
The 48 kHz, --batch and denoise variants of infer_tts run on the card
(chip_smoke.py's cli_serving phase); build_pipeline_from_train_dirs is
tested beside the CLI runs it serves (tests/test_torch_train_s2_cli.py).
The reference files (about 1 GB) are deleted after the module."""
import os
import shutil

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from megatts2_hierspeechpp_torch import convert
from megatts2_hierspeechpp_torch.cli import extract_features as cli_feats
from megatts2_hierspeechpp_torch.cli import infer_sr as cli_sr
from megatts2_hierspeechpp_torch.cli import infer_tts as cli_tts
from megatts2_hierspeechpp_torch.cli import infer_vc as cli_vc
from megatts2_hierspeechpp_torch.data import text as ttext
from megatts2_hierspeechpp_torch.infer.pipeline import (
    build_pipeline_from_reference_ckpts,
    load_wav2vec2,
)
from megatts2_hierspeechpp_torch.models import plm as tplm
from megatts2_hierspeechpp_torch.models.denoiser import MPNet
from megatts2_hierspeechpp_torch.models.speechsr import SpeechSR
from megatts2_hierspeechpp_torch.models.ttv import TTVModel
from megatts2_hierspeechpp_torch.models.vocoder import (
    HierVocoder,
    serving_state_dict,
)
from megatts2_hierspeechpp_torch.models.wav2vec2 import Wav2Vec2
from megatts2_hierspeechpp_tpu.infer.pipeline import load_torch_checkpoint as jload
from megatts2_hierspeechpp_tpu.models import convert as jconvert
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_train_s2_cli import TEXT

W2V_EXTRA = ("quantizer.codevectors", "project_q.weight", "project_hid.bias")


def _save(path, obj) -> str:
    torch.save(obj, path)
    return str(path)


def _hf_w2v(sd: dict, prefix: bool, parametrized: bool) -> dict:
    """A port Wav2Vec2 state_dict in HF Wav2Vec2ForPreTraining's layout."""
    out = dict(sd)
    for i, k in enumerate(W2V_EXTRA):
        out[k] = torch.full((3,), float(i))
    for k, v in sd.items():   # an eighth layer, which the port does not build
        if k.startswith("encoder.layers.6."):
            out[k.replace("layers.6.", "layers.7.")] = v + 1.0
    base = "encoder.pos_conv_embed.conv"
    if parametrized:
        out[f"{base}.parametrizations.weight.original0"] = out.pop(f"{base}.weight_g")
        out[f"{base}.parametrizations.weight.original1"] = out.pop(f"{base}.weight_v")
    if prefix:
        out = {(k if k in W2V_EXTRA else f"wav2vec2.{k}"): v for k, v in out.items()}
    return out


@pytest.fixture(scope="module")
def ref_files(tmp_path_factory):
    """Reference-layout checkpoints of seeded port modules, full width."""
    d = tmp_path_factory.mktemp("ref")
    gen = torch.Generator().manual_seed(0)
    ttv = TTVModel(n_vocab=ttext.N_VOCAB, n_tone=ttext.N_TONE,
                   n_language=ttext.N_LANGUAGE, seed=11, device="cpu").state_dict()
    for k, v in ttv.items():   # the reference's LSTMs train both biases
        if ".bias_hh_l" in k:
            ttv[k] = 0.1 * torch.randn(v.shape, generator=gen)
    ttv["enc_q.pre.weight"] = torch.zeros(4, 2, 1)
    voc = HierVocoder(seed=13, device="cpu", train=True).state_dict()
    sr = SpeechSR(32, 3, 1, seed=14, device="cpu").state_dict()
    sr = {**{f"dec.{k}": v for k, v in sr.items()}, "emb_g.weight": torch.zeros(3)}
    w2v = Wav2Vec2(seed=16, device="cpu").state_dict()
    files = {
        "ttv": _save(d / "ttv.pth", {"model": ttv, "iteration": 1}),
        "plm": _save(d / "plm.pth", {"model": tplm.ProsodyLM(
            seed=12, device="cpu").state_dict()}),
        "voc": _save(d / "voc.pth", {"model": voc, "iteration": 1}),
        "sr": _save(d / "sr48.pth", {"model": sr}),
        "den": _save(d / "den.pth", {"generator": MPNet(
            seed=15, device="cpu").state_dict()}),
    }
    files["w2v"] = _save(d / "w2v.bin", _hf_w2v(w2v, True, False))
    yield files
    shutil.rmtree(d)   # about 1 GB at these widths


@pytest.fixture(scope="module")
def ref_pipe(ref_files):
    f = ref_files
    return build_pipeline_from_reference_ckpts(
        f["ttv"], f["plm"], f["voc"], speechsr_ckpt=f["sr"],
        denoiser_ckpt=f["den"], device="cpu")


def _equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_reference_loaders_equal_the_jax_converters(ref_files, ref_pipe):
    f, pipe = ref_files, ref_pipe
    _equal(pipe.ttv.state_dict(),
           convert.ttv_from_jax(jconvert.convert_ttv(jload(f["ttv"]))))
    _equal(pipe.plm.state_dict(),
           convert.plm_from_jax(jconvert.convert_plm(jload(f["plm"]))))
    # the JAX tree keeps the training-only members, which serving never reads
    _equal(pipe.vocoder.state_dict(), serving_state_dict(
        convert.vocoder_from_jax(jconvert.convert_vocoder(jload(f["voc"])))))
    assert (pipe.speechsr.rate_num, pipe.speechsr.rate_den) == (3, 1)
    _equal(pipe.speechsr.state_dict(), convert.speechsr_from_jax(
        jconvert.convert_speechsr(jload(f["sr"]), "dec")))
    ckpt = torch.load(f["den"], map_location="cpu", weights_only=True)
    _equal(pipe.denoiser.state_dict(),
           convert.denoiser_from_jax(jconvert.convert_denoiser(ckpt["generator"])))
    # the folded LSTM biases: b_ih + b_hh, and 0
    sd = torch.load(f["ttv"], weights_only=True)["model"]
    k = "duration_predictor.lstms.bias_hh_l1_reverse"
    assert sd[k].abs().max() > 0
    assert torch.equal(pipe.ttv.state_dict()[k], torch.zeros_like(sd[k]))


@pytest.mark.parametrize("prefix,parametrized",
                         [(True, False), (False, True), (True, True), (False, False)])
def test_wav2vec2_loader_equals_the_jax_converter(ref_files, prefix, parametrized,
                                                  tmp_path):
    """With and without the `wav2vec2.` prefix; weight_g / weight_v or the
    parametrizations' original0 / original1."""
    if (prefix, parametrized) == (True, False):
        path = ref_files["w2v"]
    else:
        sd = torch.load(ref_files["w2v"], map_location="cpu", weights_only=True)
        sd = {k.removeprefix("wav2vec2."): v for k, v in sd.items()}
        path = _save(tmp_path / "w2v.bin", _hf_w2v(
            {k: v for k, v in sd.items() if k.startswith(("feature", "encoder"))
             and not k.startswith("encoder.layers.7.")}, prefix, parametrized))
    got = load_wav2vec2(path, "cpu").state_dict()
    sd = torch.load(path, map_location="cpu", weights_only=True)
    _equal(got, convert.wav2vec2_from_jax(jconvert.convert_wav2vec2(sd)))
    if path != ref_files["w2v"]:
        os.remove(path)


def test_a_missing_key_raises(ref_files, tmp_path):
    sd = torch.load(ref_files["plm"], weights_only=True)["model"]
    del sd["plm.layers.2.ff.3.bias"]
    bad = _save(tmp_path / "plm.pth", {"model": sd})
    with pytest.raises(KeyError, match="ff.3.bias"):
        build_pipeline_from_reference_ckpts(ref_files["ttv"], bad,
                                            ref_files["voc"], device="cpu")


# ---------------------------------------------------------------- CLIs


def _wav(path, audio: np.ndarray, sr: int = 16000) -> str:
    wavfile.write(path, sr, cli_tts.to_int16(audio))
    return str(path)


def _speech(seconds: float, f0: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    y = sum(0.2 / h * np.sin(2 * np.pi * h * f0 * t) for h in range(1, 5))
    return (y + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)


def _read(path):
    sr, data = wavfile.read(path)
    assert data.dtype == np.int16
    return sr, data


def _one_second(pipe, prompt) -> float:
    """The length_scale that puts TEXT near 50 frames (1 s)."""
    lo, hi = 0.02, 50.0
    for _ in range(30):
        ls = float(np.sqrt(lo * hi))
        n = pipe.duration(TEXT, prompt, ls)
        if abs(n - 50) <= 5:
            return ls
        lo, hi = (ls, hi) if n < 50 else (lo, ls)
    raise AssertionError("no length_scale gives 1 s")


def test_infer_tts_cli_equals_the_api(ref_files, ref_pipe, tmp_path):
    f, pipe = ref_files, ref_pipe
    prompt = _wav(tmp_path / "prompt.wav", _speech(1.0, 140.0, 1))
    txt = tmp_path / "in.txt"
    txt.write_text(TEXT + "\n\n")
    feats = pipe.prepare_prompt(cli_tts.load_wav_16k(prompt))
    ls = _one_second(pipe, feats)
    base = ["--input_txt", str(txt), "--input_prompt", prompt, "--ckpt_ttv",
            f["ttv"], "--ckpt_plm", f["plm"], "--ckpt_voc", f["voc"],
            "--length_scale", repr(ls), "--device", "cpu"]
    out = cli_tts.main(base + ["--output_dir", str(tmp_path / "plain")])
    assert [os.path.basename(o["path"]) for o in out] == ["000.wav"]
    sr, got = _read(out[0]["path"])
    want = pipe.tts(TEXT, prompt=feats, length_scale=ls)
    assert sr == 16000 and 40 * 320 <= len(got) <= 60 * 320
    np.testing.assert_array_equal(got, cli_tts.to_int16(want))

    out = cli_tts.main(base + ["--output_dir", str(tmp_path / "stream"),
                               "--stream", "--stream_chunk_frames", "32"])
    _, got = _read(out[0]["path"])
    want = np.concatenate(list(pipe.tts_stream(TEXT, prompt=feats,
                                               length_scale=ls, chunk_frames=32)))
    np.testing.assert_array_equal(got, cli_tts.to_int16(want))


def test_infer_sr_cli_equals_the_api(ref_files, ref_pipe, tmp_path):
    src = _wav(tmp_path / "utt.wav", _speech(1.0, 180.0, 2))
    out = cli_sr.main(["--input_speech", src, "--ckpt", ref_files["sr"],
                       "--output_dir", str(tmp_path), "--device", "cpu"])
    assert os.path.basename(out) == "utt_48000.wav"
    sr, got = _read(out)
    with torch.inference_mode():
        up = ref_pipe.speechsr(torch.from_numpy(cli_tts.load_wav_16k(src))[None, :, None])
    want = up[0, :, 0].numpy()
    want = want / max(np.abs(want).max(), 1e-8) * 0.999
    assert sr == 48000 and len(got) == 48000
    np.testing.assert_array_equal(got, cli_tts.to_int16(want))


def test_infer_vc_cli_equals_the_api(ref_files, ref_pipe, tmp_path):
    src = _wav(tmp_path / "src.wav", _speech(1.0, 120.0, 3))
    trg = _wav(tmp_path / "trg.wav", _speech(1.0, 210.0, 4))
    out = cli_vc.main(["--source_speech", src, "--target_speech", trg,
                       "--ckpt_voc", ref_files["voc"], "--ckpt_w2v",
                       ref_files["w2v"], "--output_dir", str(tmp_path),
                       "--device", "cpu"])
    sr, got = _read(out)
    w2v = load_wav2vec2(ref_files["w2v"], "cpu")
    want = ref_pipe.vc(cli_tts.load_wav_16k(src), cli_tts.load_wav_16k(trg), w2v)
    assert sr == 16000
    np.testing.assert_array_equal(got, cli_tts.to_int16(want))


def test_extract_features_cli_equals_the_api(ref_files, tmp_path):
    d = tmp_path / "corpus"
    (d / "sub").mkdir(parents=True)
    paths = [_wav(d / "a.wav", _speech(1.0, 150.0, 5)),
             _wav(d / "sub" / "b.wav", _speech(0.9, 230.0, 6))]
    _wav(d / "c.wav", _speech(0.5, 100.0, 7), sr=22050)   # skipped
    argv = ["--wav_dir", str(d), "--w2v_ckpt", ref_files["w2v"],
            "--device", "cpu"]
    assert cli_feats.main(argv) == paths
    w2v = load_wav2vec2(ref_files["w2v"], "cpu")
    for path in paths:
        audio = wavfile.read(path)[1].astype(np.float32) / 32768.0
        want = cli_feats.features(audio, "cpu", w2v)
        assert want["hmel"].shape[0] == 80 and want["hw2v"].shape[0] == 1024
        assert want["hf0"].shape == (4 * want["hmel"].shape[1],)
        for name, arr in want.items():
            np.testing.assert_array_equal(np.load(path[:-4] + f".{name}.npy"), arr)
    assert not os.path.exists(d / "c.hmel.npy")
    # idempotent: a second pass rewrites nothing
    stamps = {p: os.path.getmtime(p[:-4] + ".hw2v.npy") for p in paths}
    assert cli_feats.main(argv + ["--shard", "1/2"]) == []   # c.wav alone
    assert cli_feats.main(argv + ["--shard", "0/2"]) == paths
    assert {p: os.path.getmtime(p[:-4] + ".hw2v.npy") for p in paths} == stamps


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_decode_takes_a_lower_precision_latent_as_float32(dtype):
    """A greedy decode of a bf16 (or any float) latent gives exactly the
    codes of the same latent cast to float32, through the kernel's wrapper
    (its plain version on the CPU)."""
    rng = np.random.default_rng(5)
    plm = tplm.ProsodyLM(n_layers=2, seed=41, device="cpu")
    low = torch.from_numpy(rng.standard_normal((2, 37, 256)).astype(np.float32)).to(dtype)
    got = tplm.decode(plm, low)
    assert got.dtype == torch.int32 and got.shape == (2, 37)
    assert torch.equal(got, tplm.decode(plm, low.float()))
