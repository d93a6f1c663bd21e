"""HierSpeech++ vocoder GAN + VAE training CLI.

The port's counterpart of `megatts2_hierspeechpp_tpu/cli/train_vocoder.py`.
It reads sidecar features and raw 16 kHz wavs (cli/make_synth_corpus.py
writes such a corpus); linear spectra are computed on the fly. One card.

Config: the keys the JAX CLI reads (configs/hierspeechpp.json). Besides,
model.posterior_wn_layers / n_flows / flow_layers and model.mpd_resolutions
/ mpd_periods, where present, cut the model's depth (the JAX CLI builds
their defaults, which are the values these keys default to).

train.dtype is the compute dtype, as in the JAX CLI: "bf16" (the default
when the key is absent) computes in bf16 with float32 parameters, "fp32" in
float32; any other value raises.

Differences from the JAX CLI:
  - the fused stage kernels run in the step (the JAX CLI turns them off for
    its compile time; the port has no compile);
  - a resumed run starts at the epoch its step count is in (the JAX CLI
    starts again at epoch 0);
  - train.eval_plots false: the eval scalar without the excitation PNG
    (no matplotlib).

Every train.eval_interval steps (none when the key is absent, as the JAX
CLI), the eval hook synthesises the first batch of epoch 0 with the
inference path and logs eval/mel_l1 (train/evalhooks.make_vocoder_eval_fn).

Usage: python -m megatts2_hierspeechpp_torch.cli.train_vocoder \
    -c configs/hierspeechpp.json -m <run> [--device cuda]
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from megatts2_hierspeechpp_torch.data.dataset import (
    DatasetConfig,
    DistributedBucketSampler,
    SidecarDataset,
)
from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.models.discriminators import (
    PERIODS,
    VOCODER_RESOLUTIONS,
    MultiPeriodDiscriminator,
)
from megatts2_hierspeechpp_torch.models.vocoder import HierVocoder, vocoder_kwargs
from megatts2_hierspeechpp_torch.ops.stft import linear_spectrogram
from megatts2_hierspeechpp_torch.train import checkpoints as ckpt_lib
from megatts2_hierspeechpp_torch.train import vocoder as vt
from megatts2_hierspeechpp_torch.train.evalhooks import make_vocoder_eval_fn
from megatts2_hierspeechpp_torch.train.loop import run_training
from megatts2_hierspeechpp_torch.utils.config import (
    compute_dtype,
    load_hparams,
    save_hparams,
)

BOUNDARIES = (32, 300, 500, 700, 900)   # w2v frames of the length buckets
STEPS_PER_EPOCH = 1000                  # of the lr decay, as the JAX CLI


def vocoder_batch(ds: SidecarDataset, idxs, hop: int = 320,
                  pad_multiple: int = 64) -> dict:
    """Collate (spec, audio, mel, w2v, f0, mask, lengths) as numpy arrays;
    frames padded to a multiple of pad_multiple."""
    from scipy.io import wavfile

    items = [ds[i] for i in idxs]
    wavs = [wavfile.read(ds.items[i][0])[1].astype(np.float32) / 32768.0
            for i in idxs]
    t_max = max(it["w2v"].shape[0] for it in items)
    t_max = -(-t_max // pad_multiple) * pad_multiple
    b = len(items)
    batch = {
        "audio": np.zeros((b, hop * t_max), np.float32),
        "mel": np.zeros((b, t_max, 80), np.float32),
        "w2v": np.zeros((b, t_max, 1024), np.float32),
        "f0": np.zeros((b, 4 * t_max), np.float32),
        "mask": np.zeros((b, t_max, 1), np.float32),
        "lengths": np.zeros((b,), np.int64),
    }
    for i, (it, wav) in enumerate(zip(items, wavs)):
        t = it["w2v"].shape[0]
        n = min(len(wav), hop * t)
        batch["audio"][i, :n] = wav[:n]
        batch["mel"][i, :t] = it["mel"]
        batch["w2v"][i, :t] = it["w2v"]
        batch["f0"][i, :4 * t] = it["pitch"][:4 * t]
        batch["mask"][i, :t] = 1.0
        batch["lengths"][i] = t
    with torch.no_grad():
        spec = linear_spectrogram(torch.from_numpy(batch["audio"])).numpy()
    batch["spec"] = spec[:, :t_max]
    return batch


def build_state(hps, device, seed: int) -> vt.VocTrainState:
    """A step-0 train state from a config: a training build of the vocoder
    (seeded `seed`), the discriminator (`seed + 1`) and their AdamWs, both
    models computing in train.dtype ("bf16" when absent, as the JAX CLI)."""
    m, tr = hps.model, hps.train
    dtype = compute_dtype(hps)
    gen = HierVocoder(**vocoder_kwargs(hps), seed=seed, device=device,
                      train=True, dtype=dtype)
    disc = MultiPeriodDiscriminator(
        tuple(map(tuple, m.get("mpd_resolutions", VOCODER_RESOLUTIONS))),
        tuple(m.get("mpd_periods", PERIODS)), seed=seed + 1, device=device,
        dtype=dtype)
    return vt.create_state(gen, disc, lr=tr.learning_rate,
                           betas=tuple(tr.betas), eps=tr.eps,
                           lr_decay=tr.lr_decay,
                           steps_per_epoch=STEPS_PER_EPOCH)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-m", "--model", required=True)
    p.add_argument("--logs_dir", default="logs")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    hps = load_hparams(args.config)
    dev = resolve_device(args.device)
    model_dir = os.path.join(args.logs_dir, args.model)
    os.makedirs(model_dir, exist_ok=True)
    save_hparams(hps, os.path.join(model_dir, "config.json"))

    ds = SidecarDataset(hps.data.get("training_files", "filelists/train_list.txt"),
                        DatasetConfig())
    sampler = DistributedBucketSampler(ds.lengths(), hps.train.batch_size,
                                       boundaries=list(BOUNDARIES),
                                       seed=hps.train.seed)
    state = build_state(hps, dev, hps.train.seed)
    ckpt_lib.restore(os.path.join(model_dir, "ckpt"), state)
    train_step = vt.TrainStep(
        segment_frames=hps.train.get("segment_frames", 32),
        c_mel=hps.train.c_mel, c_kl=hps.train.get("c_kl", 1.0),
        c_f0=hps.train.get("c_f0", 1.0))

    def batches(epoch):
        for idx in sampler.epoch_batches(epoch):
            yield vocoder_batch(ds, idx)

    def to_device(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    eval_fn = make_vocoder_eval_fn(
        vocoder_batch(ds, sampler.epoch_batches(0)[0]),
        plot=hps.train.get("eval_plots", True))
    per_epoch = max(len(sampler.epoch_batches(0)), 1)
    return run_training(
        state, train_step, batches, model_dir, epochs=hps.train.epochs,
        seed=hps.train.seed, log_interval=hps.train.log_interval,
        save_interval=hps.train.save_interval, to_device=to_device,
        start_epoch=state.step // per_epoch,
        eval_interval=hps.train.get("eval_interval", None), eval_fn=eval_fn)


if __name__ == "__main__":
    main()
