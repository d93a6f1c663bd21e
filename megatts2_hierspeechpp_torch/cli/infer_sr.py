"""Speech super-resolution CLI (reference inference_speechsr.py).

The port's counterpart of `megatts2_hierspeechpp_tpu/cli/infer_sr.py`: a
16 kHz (or resampled) wav through the reference SpeechSR checkpoint at 24
or 48 kHz, peak-normalised to 0.999 and written as
`<output_dir>/<name>_<output_sr>.wav` (int16). On the card unless
`--device cpu`.

Usage:
  python -m megatts2_hierspeechpp_torch.cli.infer_sr \
    --input_speech in.wav --ckpt speechsr48k/G_100000.pth \
    [--output_sr 48000] [--output_dir output_sr] [--device cuda]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from megatts2_hierspeechpp_torch.cli.infer_tts import load_wav_16k, write_wav
from megatts2_hierspeechpp_torch.infer.pipeline import _peak_normalise, load_speechsr


@torch.inference_mode()
def super_resolve(model, audio: np.ndarray) -> np.ndarray:
    """(T,) at 16 kHz -> float32 numpy at the model's rate, peak 0.999."""
    dev = next(model.parameters()).device
    up = model(torch.from_numpy(np.ascontiguousarray(audio))[None, :, None].to(dev))
    return _peak_normalise(up[0, :, 0].float().cpu().numpy())


def main(argv=None) -> str:
    """Run the CLI; returns the written path."""
    p = argparse.ArgumentParser()
    p.add_argument("--input_speech", required=True)
    p.add_argument("--output_dir", default="output_sr")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--output_sr", type=int, default=48000, choices=[24000, 48000])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    model = load_speechsr(args.ckpt, args.output_sr, device=args.device)
    wav = super_resolve(model, load_wav_16k(args.input_speech))
    os.makedirs(args.output_dir, exist_ok=True)
    name = os.path.splitext(os.path.basename(args.input_speech))[0]
    out = os.path.join(args.output_dir, f"{name}_{args.output_sr}.wav")
    write_wav(out, args.output_sr, wav)
    print(out, flush=True)
    return out


if __name__ == "__main__":
    main()
