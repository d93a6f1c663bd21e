"""AR (GPT-SoVITS text-to-semantic) training CLI, s1_train.py equivalent.

The port's counterpart of `megatts2_hierspeechpp_tpu/cli/train_ar.py`, with
its defaults: Text2Semantic at the reference widths (512 wide, 12 layers, 8
heads, vocab 1025, phoneme vocab N_VOCAB * 4) in float32, ScaledAdam on the
warmup-cosine schedule (peak_lr 1e-2, from and to peak_lr / 100, warmup
2000, total 200000), gradient accumulation 4, batch 8, 100 epochs, seed
1234, collate rounding 64, the bucket boundaries [0, 200, 400, 700, 1000,
1400] of DistributedBucketSampler at one replica, the eval hook on the last
4 items every 100 micro-steps, checkpoints every 5000 and at each epoch's
end. One card.

Deliberate additions, as the port's other CLIs: `--device` (default
"cuda"; raises without CUDA), `--log_interval` (default 20, the JAX CLI's
fixed value) and `main(argv)`. A resumed run starts at the epoch of its
micro-step count, as the port's other CLIs do.

Usage: python -m megatts2_hierspeechpp_torch.cli.train_ar \
    --phoneme_path 2-name2text.txt --semantic_path 6-name2semantic.tsv -m exp_ar
"""
from __future__ import annotations

import argparse
import logging
import os

from megatts2_hierspeechpp_torch.ar import trainer
from megatts2_hierspeechpp_torch.ar.dataset import Text2SemanticDataset, collate
from megatts2_hierspeechpp_torch.ar.scaled_adam import (
    ScaledAdam,
    warmup_cosine_schedule,
)
from megatts2_hierspeechpp_torch.ar.t2s import Text2Semantic
from megatts2_hierspeechpp_torch.data import text as text_frontend
from megatts2_hierspeechpp_torch.data.dataset import DistributedBucketSampler
from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.train import checkpoints as ckpt_lib
from megatts2_hierspeechpp_torch.train.evalhooks import make_ar_eval_fn
from megatts2_hierspeechpp_torch.train.loop import run_training, to_device

log = logging.getLogger("megatts2")

BOUNDARIES = (0, 200, 400, 700, 1000, 1400)   # semantic tokens
EVAL_ITEMS = 4
EVAL_INTERVAL, SAVE_INTERVAL = 100, 5000


def build_state(args, device):
    """A step-0 state: a training build of the CLI's Text2Semantic (seeded
    args.seed) and its ScaledAdam."""
    model = Text2Semantic(phoneme_vocab_size=text_frontend.N_VOCAB * 4,
                          seed=args.seed, device=device, train=True)
    sched = warmup_cosine_schedule(args.peak_lr * 1e-2, args.peak_lr,
                                   args.peak_lr * 1e-2, args.warmup_steps,
                                   args.total_steps)
    return trainer.create_state(model, ScaledAdam(model.parameters(), lr=sched))


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--phoneme_path", required=True)
    p.add_argument("--semantic_path", required=True)
    p.add_argument("-m", "--model", required=True)
    p.add_argument("--logs_dir", default="logs")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--peak_lr", type=float, default=1e-2)
    p.add_argument("--warmup_steps", type=int, default=2000)
    p.add_argument("--total_steps", type=int, default=200000)
    p.add_argument("--grad_accum", type=int, default=4)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--pad_multiple", type=int, default=64)
    p.add_argument("--log_interval", type=int, default=20)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    model_dir = os.path.join(args.logs_dir, args.model)
    os.makedirs(model_dir, exist_ok=True)

    ds = Text2SemanticDataset(args.phoneme_path, args.semantic_path,
                              text_frontend.SYMBOL_TO_ID)
    log.info("AR dataset: %d items", len(ds))
    sampler = DistributedBucketSampler(ds.lengths(), args.batch_size,
                                       boundaries=list(BOUNDARIES),
                                       seed=args.seed)

    state = build_state(args, dev)
    if ckpt_lib.restore(os.path.join(model_dir, "ckpt"), state) is not None:
        log.info("resumed at micro-step %d", state.step)

    def batches(epoch):
        for idx in sampler.epoch_batches(epoch):
            yield collate([ds[i] for i in idx], pad_multiple=args.pad_multiple)

    # held-out eval: the last few items (they overlap training on a small
    # corpus; the hook is observability, not model selection)
    eval_batch = collate([ds[i] for i in range(max(0, len(ds) - EVAL_ITEMS),
                                               len(ds))],
                         pad_multiple=args.pad_multiple)
    per_epoch = max(len(sampler.epoch_batches(0)), 1)
    return run_training(
        state, trainer.TrainStep(args.grad_accum), batches, model_dir,
        epochs=args.epochs, seed=args.seed, log_interval=args.log_interval,
        save_interval=SAVE_INTERVAL, to_device=to_device(dev),
        start_epoch=state.step // per_epoch,
        eval_interval=EVAL_INTERVAL, eval_fn=make_ar_eval_fn(eval_batch))


if __name__ == "__main__":
    main()
