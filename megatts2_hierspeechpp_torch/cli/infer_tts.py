"""Zero-shot TTS inference CLI (reference inference_plm.py).

The port's counterpart of `megatts2_hierspeechpp_tpu/cli/infer_tts.py`: the
same arguments and behaviour, on the card unless `--device cpu`. The
prompt is read at 16 kHz (other rates resampled with the port's
kaiser-sinc filters), its features are computed once and shared by every
line of the text file, and each line is written as `<output_dir>/NNN.wav`
(int16). `--batch N` synthesises N lines per tts_batch call (16 kHz
output only); `--stream` writes each line from tts_stream's chunks (raw
gain, no peak normalisation). Each written path is printed with its ms on
the host clock.

One difference from the JAX CLI: samples are clipped to [-1, 1] before
the int16 conversion (the JAX CLI's raw-gain stream wraps around past
full scale; peak-normalised output is unchanged by the clip).

Usage:
  python -m megatts2_hierspeechpp_torch.cli.infer_tts \
    --input_txt texts.txt --input_prompt prompt.wav --output_dir out \
    --ckpt_ttv ttv_G.pth --ckpt_plm P1.pth --ckpt_voc hierspeechpp.pth \
    [--ckpt_sr speechsr48k/G_100000.pth] [--ckpt_denoiser g_best] \
    [--output_sr 48000] [--denoise_ratio 0.8] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import time
from math import gcd

import numpy as np
import torch
from scipy.io import wavfile

from megatts2_hierspeechpp_torch.infer.pipeline import (
    build_pipeline_from_reference_ckpts,
)
from megatts2_hierspeechpp_torch.ops.resample import downsample1d, upsample1d


def load_wav_16k(path: str) -> np.ndarray:
    """A wav file as float32 (T,) at 16 kHz: int16 / int32 scaled to
    [-1, 1), the first channel, other rates resampled by kaiser-sinc
    up- then down-sampling."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data[:, 0]
    if sr != 16000:
        g = gcd(sr, 16000)
        up, down = 16000 // g, sr // g
        x = torch.from_numpy(np.ascontiguousarray(data))[None, :, None]
        if up > 1:
            x = upsample1d(x, up)
        if down > 1:
            x = downsample1d(x, down)
        data = x[0, :, 0].numpy()
    return data


def write_wav(path: str, sr: int, wav: np.ndarray) -> None:
    """float samples -> int16 wav (x 32767, clipped to full scale)."""
    wavfile.write(path, sr, to_int16(wav))


def to_int16(wav: np.ndarray) -> np.ndarray:
    return (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)


def main(argv=None) -> list[dict]:
    """Run the CLI; returns one {"path", "ms"} per written wav (ms on the
    host clock: a line's own call, or its batch's call)."""
    p = argparse.ArgumentParser()
    p.add_argument("--input_txt", required=True)
    p.add_argument("--input_prompt", required=True)
    p.add_argument("--output_dir", default="output")
    p.add_argument("--ckpt_ttv", required=True)
    p.add_argument("--ckpt_plm", required=True)
    p.add_argument("--ckpt_voc", required=True)
    p.add_argument("--ckpt_sr", default=None)
    p.add_argument("--ckpt_denoiser", default=None)
    p.add_argument("--output_sr", type=int, default=16000)
    p.add_argument("--denoise_ratio", type=float, default=0.0)
    p.add_argument("--noise_scale_vc", type=float, default=0.333)
    p.add_argument("--length_scale", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--batch", type=int, default=1,
                   help="batch N texts per call (16 kHz output only)")
    p.add_argument("--stream", action="store_true",
                   help="write each utterance from its streamed chunks "
                        "(16/24/48 kHz; raw gain, no peak normalisation)")
    p.add_argument("--stream_chunk_frames", type=int, default=200)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    pipe = build_pipeline_from_reference_ckpts(
        args.ckpt_ttv, args.ckpt_plm, args.ckpt_voc,
        speechsr_ckpt=args.ckpt_sr, denoiser_ckpt=args.ckpt_denoiser,
        speechsr_rate=args.output_sr if args.output_sr != 16000 else 48000,
        device=args.device)
    prompt = load_wav_16k(args.input_prompt)
    # the prompt's features (mel, optional denoise) once, for every line
    feats = pipe.prepare_prompt(prompt, args.denoise_ratio)
    with open(args.input_txt, encoding="utf-8") as f:
        lines = [line.strip() for line in f if line.strip()]

    os.makedirs(args.output_dir, exist_ok=True)
    kw = dict(denoise_ratio=args.denoise_ratio,
              noise_scale_vc=args.noise_scale_vc,
              length_scale=args.length_scale, seed=args.seed, top_k=args.top_k)
    out = []

    def emit(i: int, wav: np.ndarray, ms: float, note: str = "") -> None:
        path = os.path.join(args.output_dir, f"{i:03d}.wav")
        write_wav(path, args.output_sr, wav)
        out.append({"path": path, "ms": ms})
        print(f"{path}  {ms:.1f} ms{note}", flush=True)

    if args.stream:
        for i, text in enumerate(lines):
            t0 = time.perf_counter()
            parts, t_first = [], None
            for chunk in pipe.tts_stream(
                    text, prompt=feats, output_sr=args.output_sr,
                    chunk_frames=args.stream_chunk_frames, **kw):
                if t_first is None:
                    t_first = 1e3 * (time.perf_counter() - t0)
                parts.append(chunk)
            wav = np.concatenate(parts)
            emit(i, wav, 1e3 * (time.perf_counter() - t0),
                 f", first chunk {t_first:.1f} ms ({len(parts)} chunks, "
                 f"{len(wav) / args.output_sr:.1f} s)")
    elif args.batch > 1 and args.output_sr == 16000:
        for i0 in range(0, len(lines), args.batch):
            t0 = time.perf_counter()
            wavs = pipe.tts_batch(lines[i0:i0 + args.batch], prompt=feats, **kw)
            ms = 1e3 * (time.perf_counter() - t0)
            for j, wav in enumerate(wavs):
                emit(i0 + j, wav, ms, f" (batch of {len(wavs)})")
    else:
        for i, text in enumerate(lines):
            t0 = time.perf_counter()
            wav = pipe.tts(text, prompt=feats, output_sr=args.output_sr, **kw)
            emit(i, wav, 1e3 * (time.perf_counter() - t0))
    return out


if __name__ == "__main__":
    main()
