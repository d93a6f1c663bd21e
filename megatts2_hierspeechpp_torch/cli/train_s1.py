"""s1-stage (prosody LM) training CLI.

The port's counterpart of `megatts2_hierspeechpp_tpu/cli/train_s1.py`
(reference train_ms_s1.py). The frozen s2 model comes from `--s2_ckpt`:
a port s2 run's checkpoint directory (`<logs>/<run>/ckpt`, its latest
step), or a reference-named `.pth` state_dict (a reference checkpoint's
"model" entry, or the state_dict itself), which the port loads as it is.
One card.

As the JAX CLI: the s2 sampler and collate (pad_multiple 64), AdamW with
the per-epoch decay at steps_per_epoch 1000, the loop, checkpoints and
resume, the s1 eval hook every train.eval_interval steps; the crop rng
seeded per epoch as cli/train_s2.py. Config keys as cli/train_s2.py;
model.plm_layers, where present, cuts the PLM's depth (default 4).
train.dtype as cli/train_s2.py ("bf16" by default): the frozen TTV and the
PLM both compute in it (JAX cli/train_s1.py:87-90), the PLM's parameters
and optimizer state stay float32.

Usage: python -m megatts2_hierspeechpp_torch.cli.train_s1 \
    -c configs/config.json -m <run> --s2_ckpt logs/<s2 run>/ckpt
"""
from __future__ import annotations

import argparse
import logging
import os
from functools import partial

import torch

from megatts2_hierspeechpp_torch.cli._evalsetup import make_eval_batch
from megatts2_hierspeechpp_torch.cli.train_s2 import (
    BOUNDARIES,
    adamw_kwargs,
    epoch_batches,
)
from megatts2_hierspeechpp_torch.data.dataset import (
    DatasetConfig,
    DistributedBucketSampler,
    SidecarDataset,
    collate,
)
from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.models.plm import ProsodyLM
from megatts2_hierspeechpp_torch.models.ttv import TTVModel, build_ttv
from megatts2_hierspeechpp_torch.train import checkpoints as ckpt_lib
from megatts2_hierspeechpp_torch.train import s1
from megatts2_hierspeechpp_torch.train.evalhooks import make_s1_eval_fn
from megatts2_hierspeechpp_torch.train.loop import run_training, to_device
from megatts2_hierspeechpp_torch.utils.config import (
    compute_dtype,
    load_hparams,
    save_hparams,
)

log = logging.getLogger("megatts2")

STEPS_PER_EPOCH = 1000   # of the lr decay, as the JAX CLI


def s2_state_dict(s2_ckpt: str) -> dict:
    """The TTV state_dict of a port s2 checkpoint directory (latest step)
    or of a reference-named .pth."""
    if s2_ckpt.endswith(".pth"):
        sd = torch.load(s2_ckpt, map_location="cpu", weights_only=True)
        return sd.get("model", sd)
    raw = ckpt_lib.restore_raw(s2_ckpt)
    if raw is None:
        raise FileNotFoundError(f"no s2 checkpoint under {s2_ckpt}")
    return raw["ttv"]


def load_s2_vars(s2_ckpt: str, hps, device) -> TTVModel:
    """The frozen s2 model: a serving build of the config's TTV, computing
    in its dtype, with the checkpoint's weights and codebooks."""
    ttv = build_ttv(hps, "cpu", hps.train.seed, train=False,
                    dtype=compute_dtype(hps))
    ttv.load_state_dict(s2_state_dict(s2_ckpt), strict=True)
    return ttv.to(device)


def build_state(hps, device, ttv: TTVModel) -> s1.S1TrainState:
    """A step-0 state: a training build of the PLM (seeded train.seed) and
    its AdamW, beside the frozen `ttv`; the PLM computes in the config's
    dtype."""
    plm = ProsodyLM(n_layers=hps.model.get("plm_layers", 4),
                    seed=hps.train.seed, device=device, train=True,
                    dtype=compute_dtype(hps))
    return s1.create_state(plm, ttv, **adamw_kwargs(hps, STEPS_PER_EPOCH))


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-m", "--model", required=True)
    p.add_argument("--s2_ckpt", required=True)
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
    sampler = DistributedBucketSampler(ds.lengths(), hps.train.batch_size,
                                       boundaries=list(BOUNDARIES),
                                       seed=hps.train.seed)
    collate_fn = partial(collate,
                         pad_multiple=int(hps.train.get("pad_multiple", 64)))
    first = collate_fn([ds[i] for i in sampler.epoch_batches(0)[0]])

    state = build_state(hps, dev, load_s2_vars(args.s2_ckpt, hps, dev))
    if ckpt_lib.restore(os.path.join(model_dir, "ckpt"), state) is not None:
        log.info("resumed at step %d", state.step)

    batches = epoch_batches(ds, sampler, collate_fn, hps.train.seed)
    eval_fn = make_s1_eval_fn(make_eval_batch(hps, fallback=first, cfg=ds_cfg))
    per_epoch = max(len(sampler.epoch_batches(0)), 1)
    return run_training(
        state, s1.TrainStep(), batches, model_dir, epochs=hps.train.epochs,
        seed=hps.train.seed, log_interval=hps.train.log_interval,
        save_interval=hps.train.save_interval, to_device=to_device(dev),
        start_epoch=state.step // per_epoch,
        eval_interval=hps.train.get("eval_interval", None), eval_fn=eval_fn)


if __name__ == "__main__":
    main()
