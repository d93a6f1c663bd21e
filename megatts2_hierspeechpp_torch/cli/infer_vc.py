"""Voice conversion CLI (reference inference_vc.py).

The port's counterpart of `megatts2_hierspeechpp_tpu/cli/infer_vc.py`: the
source's content (mms-300m wav2vec2 layer 7) and pitch contour in the
target's voice, through the reference vocoder (and optionally SpeechSR and
the denoiser), written as `<output_dir>/converted.wav` (int16). The w2v
checkpoint is an HF Wav2Vec2ForPreTraining state_dict, with or without the
`wav2vec2.` prefix, its positional conv's weight norm under either
spelling (infer/pipeline.load_wav2vec2). On the card unless `--device
cpu`. `--ckpt_ttv` / `--ckpt_plm` are accepted, as by the JAX CLI, and
unused: voice conversion needs neither.

Usage:
  python -m megatts2_hierspeechpp_torch.cli.infer_vc \
    --source_speech src.wav --target_speech trg.wav \
    --ckpt_voc hierspeechpp.pth --ckpt_w2v mms300m.bin \
    [--ckpt_sr speechsr48k/G_100000.pth] [--output_sr 48000] [--device cuda]
"""
from __future__ import annotations

import argparse
import os

from megatts2_hierspeechpp_torch.cli.infer_tts import load_wav_16k, write_wav
from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.infer.pipeline import (
    TTSPipeline,
    load_denoiser,
    load_reference,
    load_speechsr,
    load_torch_checkpoint,
    load_wav2vec2,
)
from megatts2_hierspeechpp_torch.models.vocoder import (
    HierVocoder,
    serving_state_dict,
)


def build_vc_pipeline(ckpt_voc: str, ckpt_sr=None, ckpt_denoiser=None,
                      output_sr: int = 16000, device="cuda") -> TTSPipeline:
    """A vocoder-only TTSPipeline (no TTV / PLM) from reference checkpoints;
    SpeechSR at output_sr when it is not 16 kHz."""
    dev = resolve_device(device)
    voc = load_reference(HierVocoder(device="cpu"),
                         serving_state_dict(load_torch_checkpoint(ckpt_voc)))
    sr = (load_speechsr(ckpt_sr, output_sr, device=dev)
          if ckpt_sr and output_sr != 16000 else None)
    den = load_denoiser(ckpt_denoiser, dev) if ckpt_denoiser else None
    return TTSPipeline(voc.to(dev), sr, dev, denoiser=den)


def main(argv=None) -> str:
    """Run the CLI; returns the written path."""
    p = argparse.ArgumentParser()
    p.add_argument("--source_speech", required=True)
    p.add_argument("--target_speech", required=True)
    p.add_argument("--output_dir", default="output_vc")
    p.add_argument("--ckpt_voc", required=True)
    p.add_argument("--ckpt_w2v", required=True,
                   help="HF mms-300m state dict (torch)")
    p.add_argument("--ckpt_ttv", default=None)
    p.add_argument("--ckpt_plm", default=None)
    p.add_argument("--ckpt_sr", default=None)
    p.add_argument("--ckpt_denoiser", default=None)
    p.add_argument("--output_sr", type=int, default=16000)
    p.add_argument("--denoise_ratio", type=float, default=0.0)
    p.add_argument("--noise_scale_vc", type=float, default=0.333)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    pipe = build_vc_pipeline(args.ckpt_voc, args.ckpt_sr, args.ckpt_denoiser,
                             args.output_sr, args.device)
    w2v = load_wav2vec2(args.ckpt_w2v, pipe.device)
    wav = pipe.vc(load_wav_16k(args.source_speech),
                  load_wav_16k(args.target_speech), w2v,
                  denoise_ratio=args.denoise_ratio,
                  noise_scale_vc=args.noise_scale_vc, output_sr=args.output_sr)
    os.makedirs(args.output_dir, exist_ok=True)
    out = os.path.join(args.output_dir, "converted.wav")
    write_wav(out, args.output_sr, wav)
    print(out, flush=True)
    return out


if __name__ == "__main__":
    main()
