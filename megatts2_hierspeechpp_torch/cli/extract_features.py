"""Sidecar feature extraction CLI (reference extract_mel.py / extract_f0.py
/ extract_w2v.py).

The port's counterpart of `megatts2_hierspeechpp_tpu/cli/extract_features.py`.
Walks a directory tree and, for every 16 kHz .wav (others are skipped),
writes beside it, unless the file is already there:

  .hmel.npy  (80, T)    log-mel (ops/stft.mel_spectrogram_fixed)
  .hf0.npy   (4T,)      200 Hz f0 (YIN)
  .hw2v.npy  (1024, T)  wav2vec2 layer-7 features of the audio
                        reflect-padded by 40 samples (needs --w2v_ckpt)

`--skip_mel` / `--skip_f0` leave those out; `--shard i/n` takes every n-th
file of the sorted list from the i-th. On the card unless `--device cpu`.

Usage:
  python -m megatts2_hierspeechpp_torch.cli.extract_features \
    --wav_dir corpus/ [--w2v_ckpt mms300m.bin] [--shard 0/1] [--device cuda]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F
from scipy.io import wavfile

from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.infer.pipeline import load_wav2vec2
from megatts2_hierspeechpp_torch.ops.f0 import yin_f0
from megatts2_hierspeechpp_torch.ops.stft import mel_spectrogram_fixed


def find_wavs(root: str):
    for base, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".wav"):
                yield os.path.join(base, f)


@torch.inference_mode()
def features(audio: np.ndarray, device, w2v_model=None,
             mel: bool = True, f0: bool = True) -> dict:
    """The sidecars of one 16 kHz utterance (float32 numpy): "hmel" (80, T),
    "hf0" (4T,) and, given a Wav2Vec2, "hw2v" (1024, T)."""
    x = torch.from_numpy(np.ascontiguousarray(audio, np.float32))[None].to(device)
    out = {}
    if mel:
        out["hmel"] = mel_spectrogram_fixed(x)[0].T.cpu().numpy()
    if f0:
        out["hf0"] = yin_f0(x)[0].cpu().numpy()
    if w2v_model is not None:
        xp = F.pad(x[:, None], (40, 40), mode="reflect")[:, 0]
        out["hw2v"] = w2v_model(xp)[0].T.cpu().numpy()
    return out


def main(argv=None) -> list[str]:
    """Run the CLI; returns the paths of the wavs processed."""
    p = argparse.ArgumentParser()
    p.add_argument("--wav_dir", required=True)
    p.add_argument("--w2v_ckpt", default=None,
                   help="HF Wav2Vec2ForPreTraining state dict (torch) for "
                        "mms-300m; no w2v extraction if absent")
    p.add_argument("--skip_mel", action="store_true")
    p.add_argument("--skip_f0", action="store_true")
    p.add_argument("--shard", default="0/1",
                   help="i/n: every n-th file starting at the i-th")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    shard_i, shard_n = (int(v) for v in args.shard.split("/"))
    dev = resolve_device(args.device)
    w2v = load_wav2vec2(args.w2v_ckpt, dev) if args.w2v_ckpt else None

    done = []
    for idx, path in enumerate(sorted(find_wavs(args.wav_dir))):
        if idx % shard_n != shard_i:
            continue
        sr, data = wavfile.read(path)
        if sr != 16000:
            print("skip (not 16k):", path, flush=True)
            continue
        stem = path[:-len(".wav")]
        todo = {name: f"{stem}.{name}.npy" for name in ("hmel", "hf0", "hw2v")}
        todo = {k: v for k, v in todo.items() if not os.path.exists(v)}
        feats = features(data.astype(np.float32) / 32768.0, dev,
                         w2v if "hw2v" in todo else None,
                         mel=not args.skip_mel and "hmel" in todo,
                         f0=not args.skip_f0 and "hf0" in todo)
        for name, arr in feats.items():
            np.save(todo[name], arr)
        done.append(path)
        print("done:", path, flush=True)
    return done


if __name__ == "__main__":
    main()
