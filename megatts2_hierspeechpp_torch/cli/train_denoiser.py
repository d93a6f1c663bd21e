"""MP-SENet denoiser training CLI.

The port's counterpart of `megatts2_hierspeechpp_tpu/cli/train_denoiser.py`
(the MP-SENet loss surface of reference denoiser/generator.py:150-170) over
train/denoiser.py. One card, or several under torchrun (below).

Data: clean 16 kHz wavs, every *.wav in --data_dir; the last 4 are held out
for the eval when there are more than 4. Noisy inputs are made per segment
at a random SNR in [--snr_lo, --snr_hi] dB from white plus low-passed
noise. The model is MPNet's training build at the reference widths with
both training-memory knobs on, as in the JAX CLI: each TS block
checkpointed (remat) and the attention in checkpointed query chunks of
--attn_chunk rows.

Differences from the JAX CLI:
  - training computes in float32 (the JAX CLI too has no bf16 here);
  - --device (default cuda), --log_interval (the JAX CLI's fixed 10 by
    default);
  - a resumed run starts at the epoch its step count is in (the JAX CLI
    starts again at epoch 0).

Data parallel (parallel/mesh.py): launched by torchrun (`torchrun
--nproc_per_node n -m megatts2_hierspeechpp_torch.cli.train_denoiser ...`),
each rank takes cuda:LOCAL_RANK and its rows of each global batch: every
rank draws the JAX CLI's global batch (--batch_size rows per rank) from the
same seeded stream, and rank r keeps rows r x batch_size to (r + 1) x
batch_size; the steps reduce over the ranks, rank 0 writes the run
directory, every rank resumes from it. Without the launcher's variables the
CLI runs on one card as before.

Usage: python -m megatts2_hierspeechpp_torch.cli.train_denoiser \
    --data_dir <corpus> -m <run> [--device cuda]
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from megatts2_hierspeechpp_torch.models.denoiser import MPNet
from megatts2_hierspeechpp_torch.parallel import mesh
from megatts2_hierspeechpp_torch.train import checkpoints as ckpt_lib
from megatts2_hierspeechpp_torch.train import denoiser as dnt
from megatts2_hierspeechpp_torch.train.evalhooks import make_denoiser_eval_fn
from megatts2_hierspeechpp_torch.train.loop import run_training

log = logging.getLogger("megatts2")

N_FFT, HOP, WIN = 400, 100, 400
EVAL_ROWS, EVAL_SNR_DB = 4, 5.0


def load_wavs(data_dir: str):
    """Every *.wav of data_dir, sorted by name, as float32 in [-1, 1)."""
    from scipy.io import wavfile

    paths = sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir)
                   if f.endswith(".wav"))
    return [wavfile.read(p)[1].astype(np.float32) / 32768.0 for p in paths]


def _noise_like(rng: np.random.Generator, n: int) -> np.ndarray:
    """White noise mixed with one first-order low-pass pass of itself,
    normalised to unit standard deviation. The pass is one FIR step: the
    right side is evaluated before the assignment, as in the JAX CLI."""
    white = rng.standard_normal(n).astype(np.float32)
    low = np.copy(white)
    low[1:] = 0.7 * low[:-1] + 0.3 * low[1:]
    mix = 0.6 * white + 0.4 * low
    return mix / max(np.std(mix), 1e-6)


def make_batch_iter(wavs, batch_size: int, seg: int, snr_lo: float,
                    snr_hi: float, seed: int, steps_per_epoch: int):
    """epoch -> iterator of {"clean", "noisy"} (B, seg): per row a random
    wav, a random start, an SNR and the noise, drawn from
    np.random.default_rng((seed, epoch)) in the JAX CLI's order."""
    def batches(epoch: int):
        rng = np.random.default_rng((seed, epoch))
        for _ in range(steps_per_epoch):
            clean = np.zeros((batch_size, seg), np.float32)
            noisy = np.zeros((batch_size, seg), np.float32)
            for b in range(batch_size):
                w = wavs[int(rng.integers(len(wavs)))]
                s = int(rng.integers(max(1, len(w) - seg)))
                c = w[s: s + seg]
                clean[b, : len(c)] = c
                snr_db = rng.uniform(snr_lo, snr_hi)
                p_sig = max(np.mean(np.square(c)), 1e-8)
                sigma = np.sqrt(p_sig / (10.0 ** (snr_db / 10.0)))
                noisy[b] = clean[b] + sigma * _noise_like(rng, seg)
            yield {"clean": clean, "noisy": noisy}

    return batches


def build_state(dense_channel: int, attn_chunk: int, lr: float,
                lr_decay: float, steps_per_epoch: int, device,
                seed: int, remat: bool = True) -> dnt.DenoiserTrainState:
    """A step-0 state: MPNet's training build (seeded `seed`, 4 TS blocks;
    attn_chunk 0 is the dense attention) and its AdamW with the global-norm
    clip at 5."""
    model = MPNet(dense_channel=dense_channel, attn_chunk=attn_chunk or None,
                  seed=seed, device=device, train=True, remat=remat)
    return dnt.create_state(model, lr=lr, lr_decay=lr_decay,
                            steps_per_epoch=steps_per_epoch, max_grad_norm=5.0)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", required=True)
    p.add_argument("-m", "--model", required=True)
    p.add_argument("--logs_dir", default="logs")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--steps_per_epoch", type=int, default=40)
    p.add_argument("--seg", type=int, default=32000, help="2 s @ 16 kHz")
    p.add_argument("--snr_lo", type=float, default=0.0)
    p.add_argument("--snr_hi", type=float, default=15.0)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--lr_decay", type=float, default=0.99)
    p.add_argument("--dense_channel", type=int, default=64,
                   help="MP-SENet width (ref: 64)")
    p.add_argument("--attn_chunk", type=int, default=64,
                   help="q-chunk size for the exact chunked attention "
                        "(training memory; 0 = dense)")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--eval_interval", type=int, default=50)
    p.add_argument("--log_interval", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dev = mesh.init_distributed(args.device)
    model_dir = os.path.join(args.logs_dir, args.model)
    os.makedirs(model_dir, exist_ok=True)

    wavs = load_wavs(args.data_dir)
    # the last 4 wavs feed only the eval batch (else, on a tiny corpus,
    # the eval overlaps the training data)
    ev_wavs, wavs = (wavs[-EVAL_ROWS:], wavs[:-EVAL_ROWS]) \
        if len(wavs) > EVAL_ROWS else (wavs, wavs)
    log.info("denoiser corpus: %d train wavs, %d held-out", len(wavs),
             len(ev_wavs))
    state = build_state(args.dense_channel, args.attn_chunk, args.lr,
                        args.lr_decay, args.steps_per_epoch, dev, args.seed)
    ckpt_lib.restore(os.path.join(model_dir, "ckpt"), state)
    batches = make_batch_iter(wavs, args.batch_size * mesh.world(), args.seg,
                              args.snr_lo, args.snr_hi, args.seed,
                              args.steps_per_epoch)
    # a fixed held-out batch at a fixed SNR, so evals compare across steps
    ev = next(make_batch_iter(ev_wavs, EVAL_ROWS, args.seg, EVAL_SNR_DB,
                              EVAL_SNR_DB, args.seed + 999, 1)(0))
    eval_fn = make_denoiser_eval_fn(ev, N_FFT, HOP, WIN)

    rows = slice(mesh.rank() * args.batch_size,
                 (mesh.rank() + 1) * args.batch_size)

    def to_device(batch):   # this rank's rows of the global batch
        return {k: torch.from_numpy(v[rows]).to(dev) for k, v in batch.items()}

    return run_training(
        state, dnt.TrainStep(N_FFT, HOP, WIN), batches, model_dir,
        epochs=args.epochs, seed=args.seed, log_interval=args.log_interval,
        save_interval=200, to_device=to_device,
        start_epoch=state.step // max(args.steps_per_epoch, 1),
        eval_interval=args.eval_interval, eval_fn=eval_fn)


if __name__ == "__main__":
    main()
