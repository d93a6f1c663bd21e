"""GPT-SoVITS dataset stage 2: SSL features and normalised 32 kHz wavs
(prepare_datasets/2-get-hubert-wav32k.py equivalent).

The port's counterpart of `megatts2_hierspeechpp_tpu/cli/prepare_hubert.py`:
the cnhubert-family HF HubertModel runs as the port's `Hubert`, resampling
is the port's kaiser-sinc ops (ops/resample.py), and the 32768-scale
normalisation quirk is kept exactly (2-get-hubert-wav32k.py:48-76):

  mix   = wav / max(|wav|) * (0.95 * 0.5 * 32768) + 0.5 * 32768 * wav
  skip if max(|wav|) > 2.2 or == 0; 5-wav32k gets int16(mix); 4-cnhubert
  gets SSL(resample_16k(mix)): the SSL model sees +-16k-scale floats.

PCM is scaled by its width (int16, int32: 2^(bits - 1); uint8 offset-binary).
16 kHz goes x2 up and a multiple of 32 kHz goes down to 32 kHz; any other
rate, 48 kHz included (48000 % 32000 != 0), is skipped with the JAX CLI's
message, a quirk of the JAX CLI that the port keeps.

Outputs per wav `name` (the file's basename, extension included, as in
JAX): {opt_dir}/4-cnhubert/{name}.npy (T50, hidden) and
{opt_dir}/5-wav32k/{name} (32 kHz int16). An existing feature file is
skipped. On the card unless `--device cpu` (a deliberate addition, with
`main(argv)`).

Usage: python -m megatts2_hierspeechpp_torch.cli.prepare_hubert \
    --filelist list.txt --opt_dir out --ssl_ckpt chinese-hubert-base/ \
    [--n_heads 12] [--shard i/n] [--device cuda]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from scipy.io import wavfile

from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.infer.pipeline import load_hubert
from megatts2_hierspeechpp_torch.ops.resample import downsample1d, upsample1d

MAXX = 0.95
ALPHA = 0.5


def normalize_mix(wav: np.ndarray) -> np.ndarray | None:
    """wav float [-1, 1] -> +-32768-scale mix, or None if peak-filtered."""
    peak = np.abs(wav).max()
    if peak > 2.2 or peak == 0.0:
        return None
    return wav / peak * (MAXX * ALPHA * 32768.0) + ((1 - ALPHA) * 32768.0) * wav


def pcm_to_float(data: np.ndarray) -> np.ndarray:
    """Integer PCM scaled by its own width (int16 / int32 / ...: 2^(bits -
    1); uint8 offset-binary); float data as it is, in float32."""
    wav = data.astype(np.float32)
    if data.dtype.kind == "i":
        wav = wav / float(2 ** (8 * data.dtype.itemsize - 1))
    elif data.dtype.kind == "u":
        wav = (wav - 128.0) / 128.0
    return wav


def wav_32k(wav_path: str, device) -> np.ndarray | None:
    """The file at 32 kHz, float32 on [-1, 1] (pcm_to_float): 16 kHz x2
    up, a multiple of 32 kHz down (ops/resample.py on `device`); None, with
    the JAX CLI's message, for any other rate."""
    sr, data = wavfile.read(wav_path)
    wav = pcm_to_float(data)
    if sr == 32000:
        return wav
    x = torch.from_numpy(wav).to(device)[None, :, None]
    if sr == 16000:
        x = upsample1d(x, 2)
    elif sr % 32000 == 0:
        x = downsample1d(x, sr // 32000)
    else:
        print("skip (sr %d not 16k/32k-divisible): %s" % (sr, wav_path))
        return None
    return x[0, :, 0].cpu().numpy()


def ssl_input(mix: np.ndarray, device) -> torch.Tensor:
    """The SSL model's input (1, T16): the 16 kHz resample of the
    +-32768-scale mix (the quirk kept)."""
    x = torch.from_numpy(mix.astype(np.float32)).to(device)[None, :, None]
    return downsample1d(x, 2)[:, :, 0]


def _load_state_dict(path: str) -> dict:
    """An HF HubertModel state_dict from a directory (pytorch_model.bin or
    model.safetensors) or a file (load_hubert strips a `hubert.`
    prefix)."""
    if os.path.isdir(path):
        for cand in ("pytorch_model.bin", "model.safetensors"):
            full = os.path.join(path, cand)
            if os.path.exists(full):
                path = full
                break
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--filelist", required=True,
                   help="lines: wav_path|spk|lang|text; only the wav path is used")
    p.add_argument("--opt_dir", required=True)
    p.add_argument("--ssl_ckpt", required=True,
                   help="HF HubertModel dir or .bin/.safetensors state dict "
                        "(cnhubert family, base variant)")
    p.add_argument("--n_heads", type=int, default=12,
                   help="attention heads (not recoverable from a state dict)")
    p.add_argument("--shard", default="0/1", help="i/n fan-out")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    shard_i, shard_n = (int(v) for v in args.shard.split("/"))
    dev = resolve_device(args.device)

    model = load_hubert(_load_state_dict(args.ssl_ckpt), args.n_heads, dev)
    hubert_dir = os.path.join(args.opt_dir, "4-cnhubert")
    wav32_dir = os.path.join(args.opt_dir, "5-wav32k")
    os.makedirs(hubert_dir, exist_ok=True)
    os.makedirs(wav32_dir, exist_ok=True)

    with open(args.filelist, encoding="utf-8") as f:
        lines = [ln.strip() for ln in f if ln.strip()]

    done = []
    for idx, line in enumerate(lines):
        if idx % shard_n != shard_i:
            continue
        wav_path = line.split("|")[0]
        name = os.path.basename(wav_path)
        out_feat = os.path.join(hubert_dir, name + ".npy")
        if os.path.exists(out_feat):
            continue
        wav = wav_32k(wav_path, dev)
        if wav is None:
            continue
        mix = normalize_mix(wav)
        if mix is None:
            print("filtered (peak): %s" % wav_path)
            continue
        with torch.inference_mode():
            feats = model(ssl_input(mix, dev))[0].cpu().numpy()
        if not np.isfinite(feats).all():
            print("nan-filtered: %s" % wav_path)
            continue
        wavfile.write(os.path.join(wav32_dir, name), 32000,
                      np.clip(mix, -32768, 32767).astype(np.int16))
        np.save(out_feat, feats.astype(np.float32))
        print("done:", name)
        done.append(name)
    return done


if __name__ == "__main__":
    main()
