"""s2-stage (MegaTTS2 acoustic model) training CLI.

The port's counterpart of `megatts2_hierspeechpp_tpu/cli/train_s2.py`
(reference train_ms.py). It reads the sidecar features of a filelist
(cli/make_synth_corpus.py writes such a corpus). One card.

  - SidecarDataset + DistributedBucketSampler with the JAX boundaries;
    `collate` pads frames to a multiple of train.pad_multiple (64);
  - a training build of TTVModel (seeded train.seed) and the
    MultiResSpecDiscriminator (train.seed + 1), AdamW for each;
  - on a fresh run, k-means fits the RVQ codebooks on the first batch's
    quantizer inputs (`pre_vq_features`, masked frames left out); a
    resumed run keeps its checkpoint's;
  - the loop, checkpoints (torch.save, keep 3) and resume, the s2 eval hook
    every train.eval_interval steps (train.eval_plots false: scalars only,
    no matplotlib).

Config: the keys the JAX CLI reads (configs/config.json); model.text_layers,
mel_enc_layers, w2v_enc_layers and w2v_dec_layers, where present, cut the
model's depth (the defaults are the published depths).

Kept from the JAX CLI, quirk included: the learning rate decays once per
`steps_per_epoch` updates, which is the number of *samples* in epoch 0's
batches (JAX cli/train_s2.py:79), while a resumed run's start epoch counts
batches.

Compute dtype as the JAX CLI's (JAX cli/train_s2.py:67-71): train.dtype
"bf16" (the default) runs the TTV and the discriminator in bf16 compute
with float32 parameters, "fp32" in float32; any other value raises.

Difference from the JAX CLI: the dataset's MRTE-crop rng is seeded again at
each epoch from (train.seed, epoch), so a run resumed at an epoch boundary
sees the batches a straight run would (the JAX CLI's rng runs on from
wherever the restart left it).

Usage: python -m megatts2_hierspeechpp_torch.cli.train_s2 \
    -c configs/config.json -m <run> [--logs_dir logs] [--device cuda]
"""
from __future__ import annotations

import argparse
import logging
import os
from functools import partial

import numpy as np
import torch

from megatts2_hierspeechpp_torch.cli._evalsetup import make_eval_batch
from megatts2_hierspeechpp_torch.data.dataset import (
    DatasetConfig,
    DistributedBucketSampler,
    SidecarDataset,
    collate,
)
from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.models.discriminators import (
    MultiResSpecDiscriminator,
)
from megatts2_hierspeechpp_torch.models.ttv import TTVModel, build_ttv
from megatts2_hierspeechpp_torch.ops.kmeans import init_rvq_state
from megatts2_hierspeechpp_torch.train import checkpoints as ckpt_lib
from megatts2_hierspeechpp_torch.train import s2
from megatts2_hierspeechpp_torch.train.evalhooks import make_s2_eval_fn
from megatts2_hierspeechpp_torch.train.loop import run_training, to_device
from megatts2_hierspeechpp_torch.utils.config import (
    compute_dtype,
    load_hparams,
    save_hparams,
)

log = logging.getLogger("megatts2")

BOUNDARIES = (32, 300, 400, 500, 600, 700, 800, 900, 1000)  # w2v frames
def adamw_kwargs(hps, steps_per_epoch: int) -> dict:
    tr = hps.train
    return dict(lr=tr.learning_rate, betas=tuple(tr.betas), eps=tr.eps,
                lr_decay=tr.lr_decay, steps_per_epoch=steps_per_epoch)


def build_state(hps, device, seed: int, steps_per_epoch: int) -> s2.S2TrainState:
    """A step-0 state: a training build of the TTV (seeded `seed`), the
    MRSD (`seed + 1`), both computing in the config's dtype, and their
    AdamWs."""
    dtype = compute_dtype(hps)
    ttv = build_ttv(hps, device, seed, train=True, dtype=dtype)
    disc = MultiResSpecDiscriminator(seed=seed + 1, device=device, dtype=dtype)
    return s2.create_state(ttv, disc, **adamw_kwargs(hps, steps_per_epoch))


def kmeans_init(ttv: TTVModel, batch: dict, seed: int) -> None:
    """Fit the codebooks on the quantizer inputs of `batch` (numpy, as
    collate gives it), padding frames left out."""
    dev = next(ttv.parameters()).device
    with torch.no_grad():
        feats, pool_mask = ttv.pre_vq_features(
            torch.from_numpy(batch["mel"]).to(dev),
            torch.from_numpy(batch["mel_lengths"]).to(dev))
    keep = pool_mask[..., 0].reshape(-1).cpu().numpy() > 0
    samples = feats.reshape(-1, feats.shape[-1]).cpu().numpy()[keep]
    init_rvq_state(ttv.quantizer, samples, seed=seed)


def epoch_batches(ds: SidecarDataset, sampler: DistributedBucketSampler,
                  collate_fn, seed: int):
    """batches(epoch): the collated batches of one epoch, the dataset's
    crop rng seeded from (seed, epoch) first."""

    def batches(epoch):
        ds.rng.seed(seed * 100_003 + epoch)
        for idx in sampler.epoch_batches(epoch):
            yield collate_fn([ds[i] for i in idx])

    return batches


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-m", "--model", required=True)
    p.add_argument("--logs_dir", default="logs")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    hps = load_hparams(args.config)
    compute_dtype(hps)
    dev = resolve_device(args.device)
    model_dir = os.path.join(args.logs_dir, args.model)
    os.makedirs(model_dir, exist_ok=True)
    save_hparams(hps, os.path.join(model_dir, "config.json"))

    ds_cfg = DatasetConfig()
    ds = SidecarDataset(hps.data.training_files, ds_cfg)
    log.info("dataset size: %d", len(ds))
    sampler = DistributedBucketSampler(ds.lengths(), hps.train.batch_size,
                                       boundaries=list(BOUNDARIES),
                                       seed=hps.train.seed)
    # the JAX CLI's schedule: samples (not batches) of epoch 0 per decay
    steps_per_epoch = max(sum(len(b) for b in sampler.epoch_batches(0)), 1)
    collate_fn = partial(collate,
                         pad_multiple=int(hps.train.get("pad_multiple", 64)))
    first = collate_fn([ds[i] for i in sampler.epoch_batches(0)[0]])

    state = build_state(hps, dev, hps.train.seed, steps_per_epoch)
    if ckpt_lib.restore(os.path.join(model_dir, "ckpt"), state) is not None:
        log.info("resumed at step %d", state.step)
    else:
        kmeans_init(state.ttv, first, hps.train.seed)
        log.info("k-means initialized RVQ codebooks")
    train_step = s2.TrainStep(c_mel=hps.train.c_mel,
                              c_commit=hps.train.get("c_commit", 100.0))

    batches = epoch_batches(ds, sampler, collate_fn, hps.train.seed)
    eval_fn = make_s2_eval_fn(make_eval_batch(hps, fallback=first, cfg=ds_cfg),
                              plot=hps.train.get("eval_plots", True))
    per_epoch = max(len(sampler.epoch_batches(0)), 1)
    return run_training(
        state, train_step, batches, model_dir, epochs=hps.train.epochs,
        seed=hps.train.seed, log_interval=hps.train.log_interval,
        save_interval=hps.train.save_interval, to_device=to_device(dev),
        start_epoch=state.step // per_epoch,
        eval_interval=hps.train.get("eval_interval", None), eval_fn=eval_fn)


if __name__ == "__main__":
    main()
