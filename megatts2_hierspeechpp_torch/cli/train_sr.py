"""SpeechSR (16 kHz -> 24 / 48 kHz) GAN training CLI.

The port's counterpart of `megatts2_hierspeechpp_tpu/cli/train_sr.py`
(reference speechsr48k / speechsr24k configs: segment 9600 at 48 kHz, i.e.
3200 at 16 kHz in, c_mel 45, AdamW lr 1e-4 betas (0.8, 0.99), lr decay 0.995
per epoch; their in-file discriminator bank) over train/speechsr.py. One
card.

Data: raw 16 kHz wavs, listed by --data_dir/trans.txt (the synthetic
corpus's layout) or else every *.wav in --data_dir. The target is
polyphase-resampled from the input at load, or read from --hi_dir (native
hi-rate wavs of the same names).

Differences from the JAX CLI:
  - training computes in float32 (the JAX CLI too has no bf16 here);
  - --device (default cuda);
  - --no_eval_plots: the eval scalars without the PNGs (no matplotlib);
  - --log_interval (the JAX CLI's fixed 10 by default);
  - a resumed run starts at the epoch its step count is in (the JAX CLI
    starts again at epoch 0).

Usage: python -m megatts2_hierspeechpp_torch.cli.train_sr \
    --data_dir <corpus> -m <run> [--out_sr 48000] [--device cuda]
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.models.discriminators import (
    SPEECHSR48_RESOLUTIONS,
    VOCODER_RESOLUTIONS,
    MultiPeriodDiscriminator,
)
from megatts2_hierspeechpp_torch.models.speechsr import SpeechSR, rate_for
from megatts2_hierspeechpp_torch.train import checkpoints as ckpt_lib
from megatts2_hierspeechpp_torch.train import speechsr as srt
from megatts2_hierspeechpp_torch.train.evalhooks import make_sr_eval_fn
from megatts2_hierspeechpp_torch.train.loop import run_training

log = logging.getLogger("megatts2")

EVAL_ROWS = 4


def load_corpus(data_dir: str, hi_dir: str | None, num: int, den: int):
    """(lo_wavs, hi_wavs) float32 lists; each lo cut to a multiple of den,
    so that its hi is exactly len(lo) * num / den samples and segment starts
    align sample for sample."""
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    trans = os.path.join(data_dir, "trans.txt")
    if os.path.exists(trans):  # `wav_path|spk|text` lines
        with open(trans) as f:
            paths = [line.split("|")[0].strip() for line in f if line.strip()]
    else:
        paths = sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir)
                       if f.endswith(".wav"))
    lo_wavs, hi_wavs = [], []
    for p in paths:
        lo = wavfile.read(p)[1].astype(np.float32) / 32768.0
        if den > 1:
            lo = lo[: len(lo) - len(lo) % den]
        if hi_dir is not None:
            hi = wavfile.read(os.path.join(hi_dir, os.path.basename(p)))[1]
            hi = (hi.astype(np.float32) / 32768.0)[: len(lo) * num // den]
        else:
            hi = resample_poly(lo.astype(np.float64), num, den).astype(np.float32)
        lo_wavs.append(lo)
        hi_wavs.append(hi)
    return lo_wavs, hi_wavs


def _segment(lo_w, hi_w, s: int, seg_in: int, num: int, den: int, lo, hi, b):
    """Row b of (lo, hi) from input sample s on; the rest stays zero."""
    seg = lo_w[s: s + seg_in]
    lo[b, : len(seg), 0] = seg
    h = hi_w[s * num // den: s * num // den + hi.shape[1]]
    hi[b, : len(h), 0] = h


def make_batch_iter(lo_wavs, hi_wavs, batch_size: int, seg_in: int,
                    num: int, den: int, seed: int, steps_per_epoch: int):
    """epoch -> iterator of {"lo": (B, seg_in, 1), "hi": (B, seg_in * num /
    den, 1)}: per row a random wav and a random start, a multiple of den,
    drawn from np.random.default_rng((seed, epoch)) in the JAX CLI's
    order."""
    def batches(epoch: int):
        rng = np.random.default_rng((seed, epoch))
        seg_out = seg_in * num // den
        for _ in range(steps_per_epoch):
            lo = np.zeros((batch_size, seg_in, 1), np.float32)
            hi = np.zeros((batch_size, seg_out, 1), np.float32)
            for b in range(batch_size):
                i = int(rng.integers(len(lo_wavs)))
                max_start = max(1, (len(lo_wavs[i]) - seg_in) // den)
                s = int(rng.integers(max_start)) * den
                _segment(lo_wavs[i], hi_wavs[i], s, seg_in, num, den, lo, hi, b)
            yield {"lo": lo, "hi": hi}

    return batches


def eval_batch(lo_wavs, hi_wavs, seg_in: int, num: int, den: int, seed: int):
    """The held-out batch of the JAX CLI: EVAL_ROWS segments of the last
    wavs, starts drawn from np.random.default_rng(seed + 999)."""
    rng = np.random.default_rng(seed + 999)
    lo = np.zeros((EVAL_ROWS, seg_in, 1), np.float32)
    hi = np.zeros((EVAL_ROWS, seg_in * num // den, 1), np.float32)
    for b in range(EVAL_ROWS):
        i = len(lo_wavs) - 1 - (b % min(EVAL_ROWS, len(lo_wavs)))
        s = int(rng.integers(max(1, (len(lo_wavs[i]) - seg_in) // den))) * den
        _segment(lo_wavs[i], hi_wavs[i], s, seg_in, num, den, lo, hi, b)
    return {"lo": lo, "hi": hi}


def build_state(out_sr: int, ch: int, lr: float, lr_decay: float,
                steps_per_epoch: int, device, seed: int) -> srt.SRTrainState:
    """A step-0 state: a training build of SpeechSR (seeded `seed`), the
    target rate's discriminator bank (`seed + 1`; the 48 kHz recipe adds a
    4096-point resolution) and their AdamWs."""
    num, den = rate_for(out_sr)
    gen = SpeechSR(ch, num, den, seed=seed, device=device, train=True)
    disc = MultiPeriodDiscriminator(
        SPEECHSR48_RESOLUTIONS if out_sr == 48000 else VOCODER_RESOLUTIONS,
        seed=seed + 1, device=device)
    return srt.create_state(gen, disc, lr=lr, lr_decay=lr_decay,
                            steps_per_epoch=steps_per_epoch)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", required=True)
    p.add_argument("--hi_dir", default=None,
                   help="native hi-rate wavs (else polyphase-resample lo)")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("--logs_dir", default="logs")
    p.add_argument("--out_sr", type=int, default=48000, choices=(24000, 48000))
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--steps_per_epoch", type=int, default=40)
    p.add_argument("--seg_in", type=int, default=3200,
                   help="16 kHz input segment (ref: 9600 @ 48k target)")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_decay", type=float, default=0.995)
    p.add_argument("--c_mel", type=float, default=45.0)
    p.add_argument("--ch", type=int, default=32,
                   help="upsample_initial_channel (ref speechsr: 32)")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--eval_interval", type=int, default=50)
    p.add_argument("--log_interval", type=int, default=10)
    p.add_argument("--no_eval_plots", action="store_true",
                   help="eval scalars only (no matplotlib)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    num, den = rate_for(args.out_sr)
    dev = resolve_device(args.device)
    model_dir = os.path.join(args.logs_dir, args.model)
    os.makedirs(model_dir, exist_ok=True)

    lo_wavs, hi_wavs = load_corpus(args.data_dir, args.hi_dir, num, den)
    log.info("SR corpus: %d wavs (out_sr=%d)", len(lo_wavs), args.out_sr)
    state = build_state(args.out_sr, args.ch, args.lr, args.lr_decay,
                        args.steps_per_epoch, dev, args.seed)
    ckpt_lib.restore(os.path.join(model_dir, "ckpt"), state)
    batches = make_batch_iter(lo_wavs, hi_wavs, args.batch_size, args.seg_in,
                              num, den, args.seed, args.steps_per_epoch)
    eval_fn = make_sr_eval_fn(
        eval_batch(lo_wavs, hi_wavs, args.seg_in, num, den, args.seed),
        args.out_sr, plot=not args.no_eval_plots)

    def to_device(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    return run_training(
        state, srt.TrainStep(c_mel=args.c_mel, sr_out=args.out_sr), batches,
        model_dir, epochs=args.epochs, seed=args.seed,
        log_interval=args.log_interval,
        save_interval=200, to_device=to_device,
        start_epoch=state.step // max(args.steps_per_epoch, 1),
        eval_interval=args.eval_interval, eval_fn=eval_fn)


if __name__ == "__main__":
    main()
