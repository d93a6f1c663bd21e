"""The port's Hubert (models/wav2vec2.py) and cli/prepare_hubert against the
JAX package on the CPU:

  - Hubert against JAX Hubert, the JAX params made by the JAX package's own
    convert_hubert from the port's HF-named state_dict, under both
    weight-norm spellings of the positional conv (weight_g / weight_v and
    parametrizations.weight.original0 / original1), and through the port's
    loader (load_hubert) of the same file; hubert_from_jax back to the
    port's names;
  - normalize_mix against JAX's, the peak filter's two ends included;
  - cli/prepare_hubert.main against the JAX CLI (its main through a
    monkeypatched sys.argv) on wavs at 16, 32 and 64 kHz (int16, int32,
    uint8 and float PCM), 48 and 22.05 kHz ones (skipped by both), one
    over the peak filter and one silent.

Small configuration: hidden 64, 2 layers, 4 heads, FFN 128, conv_dim
(32,) x 7, positional conv kernel 16 in 4 groups; seeded port weights
(norm scales near 1, biases nonzero). Tolerances: features 1e-4 x max|ref|,
5-wav32k samples 1 LSB, the skipped and filtered files exactly."""
import os
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax

from megatts2_hierspeechpp_torch.cli import prepare_hubert as tph
from megatts2_hierspeechpp_torch.convert import hubert_from_jax
from megatts2_hierspeechpp_torch.infer.pipeline import load_hubert
from megatts2_hierspeechpp_torch.models.wav2vec2 import Hubert
from megatts2_hierspeechpp_tpu.cli import prepare_hubert as jph
from megatts2_hierspeechpp_tpu.models import wav2vec2 as jw2v
from megatts2_hierspeechpp_tpu.models.convert import convert_hubert
from tests.test_torch_kernels import few_torch_threads  # noqa: F401

SMALL = dict(hidden_size=64, n_heads=4, ffn_dim=128, n_layers=2,
             pos_conv_kernel=16, pos_conv_groups=4, conv_dim=(32,) * 7)
POS = "encoder.pos_conv_embed.conv"


def port_hubert(seed=5) -> Hubert:
    m = Hubert(**SMALL, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in m.named_parameters():
            n = torch.randn(p.shape, generator=gen)
            if "norm" in name and name.endswith("weight"):
                p.copy_(1.0 + 0.1 * n)
            elif name.endswith("bias"):
                p.copy_(0.05 * n)
    return m


def hf_names(sd: dict, parametrized: bool) -> dict:
    """The port's state_dict as an HF file with the `hubert.` prefix, the
    positional conv under either weight-norm spelling."""
    out = dict(sd)
    if parametrized:
        out[f"{POS}.parametrizations.weight.original0"] = out.pop(f"{POS}.weight_g")
        out[f"{POS}.parametrizations.weight.original1"] = out.pop(f"{POS}.weight_v")
    return {f"hubert.{k}": v for k, v in out.items()}


@pytest.fixture(scope="module")
def hubert():
    return port_hubert()


def _wave(n, seed):
    return np.random.default_rng(seed).standard_normal((1, n)).astype(np.float32)


@pytest.mark.parametrize("parametrized", [False, True])
def test_hubert_matches_jax(hubert, parametrized, tmp_path):
    sd = hf_names(hubert.state_dict(), parametrized)
    params = convert_hubert(sd, n_layers=SMALL["n_layers"])
    jm = jw2v.Hubert(**SMALL)
    x = _wave(6400, 1) * 3000.0
    want = np.asarray(jax.jit(jm.apply)({"params": params}, x))
    torch.save(sd, tmp_path / "h.bin")
    loaded = load_hubert(tph._load_state_dict(str(tmp_path / "h.bin")),
                         SMALL["n_heads"], "cpu")
    for m in (hubert, loaded):
        with torch.no_grad():
            got = m(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == (1, 19, 64)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_hubert_from_jax_round_trip(hubert):
    sd = hubert.state_dict()
    back = hubert_from_jax(convert_hubert(hf_names(sd, False), SMALL["n_layers"]))
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_allclose(back[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("scale", [0.1, 1.0, 2.2, 2.3, 0.0])
def test_normalize_mix_matches_jax(scale):
    wav = np.clip(_wave(320, 2)[0], -1, 1) * scale
    want, got = jph.normalize_mix(wav), tph.normalize_mix(wav)
    if want is None:
        assert got is None and (scale > 2.2 or scale == 0.0)
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _speech(sr, seconds, seed):
    t = np.arange(int(sr * seconds)) / sr
    rng = np.random.default_rng(seed)
    return 0.3 * np.sin(2 * np.pi * 180 * t) + 0.05 * rng.standard_normal(t.shape)


WAVS = {   # name: (rate, PCM kind)
    "a16_int16.wav": (16000, "int16"),
    "b32_int32.wav": (32000, "int32"),
    "c64_uint8.wav": (64000, "uint8"),
    "d32_float.wav": (32000, "float32"),
    "e48_int16.wav": (48000, "int16"),
    "f22_int16.wav": (22050, "int16"),
    "g32_loud.wav": (32000, "loud"),
    "h16_silent.wav": (16000, "silent"),
}


def _pcm(x, kind):
    if kind == "int16":
        return (x * 32767).astype(np.int16)
    if kind == "int32":
        return (x * 2 ** 31 * 0.99).astype(np.int32)
    if kind == "uint8":
        return np.clip(x * 127 + 128, 0, 255).astype(np.uint8)
    if kind == "loud":
        return (x * 10.0).astype(np.float32)     # peak over 2.2
    if kind == "silent":
        return np.zeros(len(x), np.int16)
    return x.astype(np.float32)


def run_cli(main, argv, capsys, monkeypatch=None):
    if monkeypatch is None:
        main(argv[1:])
    else:
        monkeypatch.setattr(sys, "argv", argv)
        main()
    lines = capsys.readouterr().out.splitlines()
    return sorted(ln for ln in lines if ln.startswith(("skip", "filtered")))


def test_prepare_hubert_matches_jax_cli(hubert, tmp_path, capsys, monkeypatch):
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    for i, (name, (sr, kind)) in enumerate(WAVS.items()):
        wavfile.write(wav_dir / name, sr, _pcm(_speech(sr, 0.6 + 0.1 * i, i), kind))
    filelist = tmp_path / "list.txt"
    filelist.write_text("".join(f"{wav_dir / n}|spk|zh|text\n" for n in WAVS))
    ckpt = tmp_path / "hubert.bin"
    torch.save(hf_names(hubert.state_dict(), False), ckpt)
    args = ["--filelist", str(filelist), "--ssl_ckpt", str(ckpt), "--n_heads",
            str(SMALL["n_heads"])]
    skipped = {}
    for side, main, mp in (("jax", jph.main, monkeypatch), ("port", tph.main, None)):
        argv = ["prepare_hubert", *args, "--opt_dir", str(tmp_path / side)]
        if side == "port":
            argv += ["--device", "cpu"]
        skipped[side] = run_cli(main, argv, capsys, mp)
    strip = [ln.replace(str(wav_dir), "") for ln in skipped["port"]]
    assert strip == [ln.replace(str(wav_dir), "") for ln in skipped["jax"]]
    assert len(strip) == 4    # 48 kHz, 22.05 kHz, the loud one, the silent one
    kept = sorted(os.listdir(tmp_path / "jax" / "4-cnhubert"))
    assert kept == sorted(os.listdir(tmp_path / "port" / "4-cnhubert"))
    assert kept == [f"{n}.npy" for n in list(WAVS)[:4]]
    for name in list(WAVS)[:4]:
        want = np.load(tmp_path / "jax" / "4-cnhubert" / f"{name}.npy")
        got = np.load(tmp_path / "port" / "4-cnhubert" / f"{name}.npy")
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)
        sw, w = wavfile.read(tmp_path / "jax" / "5-wav32k" / name)
        sg, g = wavfile.read(tmp_path / "port" / "5-wav32k" / name)
        assert sw == sg == 32000 and g.dtype == w.dtype == np.int16
        assert g.shape == w.shape
        assert np.abs(g.astype(np.int32) - w).max() <= 1, name


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only case")
def test_prepare_hubert_raises_without_cuda(tmp_path):
    """--device defaults to cuda: without CUDA the CLI raises before it
    reads anything, it does not move to the CPU."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tph.main(["--filelist", "x", "--opt_dir", str(tmp_path), "--ssl_ckpt", "y"])
