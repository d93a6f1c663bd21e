"""The training loop shared by the trainers.

Counterpart of `megatts2_hierspeechpp_tpu/train/loop.py`: epoch-seeded
bucket batches, host loading with a prefetch thread, the train step,
scalars every `log_interval` steps (JSONL + log), checkpoints every
`save_interval` steps and at each epoch's end, an optional eval hook.

Each step's torch.Generator is seeded from (seed, epoch, index in the
epoch), so a restart at an epoch boundary replays the same draws (the
JAX loop's fold_in(fold_in(seed, epoch), i)).
"""
from __future__ import annotations

import json
import logging
import os
import subprocess
import threading
import time
from queue import Queue
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from megatts2_hierspeechpp_torch.train import checkpoints as ckpt_lib

log = logging.getLogger("megatts2")


class ScalarLogger:
    """Appends one JSON record per logged step to `<model_dir>/scalars.jsonl`."""

    def __init__(self, model_dir: str):
        os.makedirs(model_dir, exist_ok=True)
        self.path = os.path.join(model_dir, "scalars.jsonl")

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def prefetch(iterable: Iterable, size: int = 2):
    """Yields the items of `iterable`, produced `size` ahead in a thread.
    An error in the producer is raised in the consumer."""
    q: Queue = Queue(maxsize=size)
    done = object()

    def producer():
        try:
            for item in iterable:
                q.put(item)
            q.put(done)
        except BaseException as e:  # noqa: BLE001 (re-raised in the consumer)
            q.put(e)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def stamp_git_provenance(model_dir: str) -> None:
    """Write the repository's git hash to `<model_dir>/githash`, warning
    when it changed since the run began (reference utils.check_git_hash).
    Outside a git checkout nothing is written."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        h = subprocess.run(["git", "-C", repo, "rev-parse", "HEAD"],
                           capture_output=True, text=True,
                           timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return
    if not h:
        return
    path = os.path.join(model_dir, "githash")
    if os.path.exists(path):
        with open(path) as f:
            prev = f.read().strip()
        if prev and prev != h:
            log.warning("git hash changed since this run dir was created: "
                        "%s -> %s", prev[:8], h[:8])
    os.makedirs(model_dir, exist_ok=True)
    with open(path, "w") as f:
        f.write(h + "\n")


def to_device(dev):
    """A batch of numpy arrays -> the same dict of tensors on `dev` (the
    `to_device` of run_training)."""
    return lambda batch: {k: torch.from_numpy(v).to(dev)
                          for k, v in batch.items()}


def step_generator(seed: int, epoch: int, index: int) -> torch.Generator:
    """The CPU generator of step `index` of `epoch`."""
    s = np.random.SeedSequence([seed, epoch, index]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(s[0]))


def run_training(state, train_step: Callable,
                 batch_iter_fn: Callable[[int], Iterable[Dict]],
                 model_dir: str, epochs: int, seed: int = 1234,
                 log_interval: int = 20, save_interval: int = 5000,
                 to_device: Optional[Callable] = None, start_epoch: int = 0,
                 eval_interval: Optional[int] = None,
                 eval_fn: Optional[Callable] = None):
    """train_step(state, batch, generator) -> (state, metrics) over
    epochs start_epoch .. epochs - 1; `batch_iter_fn(epoch)` yields host
    batches (made in the prefetch thread), which `to_device` moves before
    the step. Returns the state."""
    logger = ScalarLogger(model_dir)
    stamp_git_provenance(model_dir)
    ckpt_dir = os.path.join(model_dir, "ckpt")
    t_last = time.time()
    for epoch in range(start_epoch, epochs):
        for i, batch in enumerate(prefetch(batch_iter_fn(epoch))):
            if to_device is not None:
                batch = to_device(batch)
            state, metrics = train_step(state, batch,
                                        step_generator(seed, epoch, i))
            step = state.step
            if step % log_interval == 0:
                scalars = {k: float(v) for k, v in metrics.items()}
                now = time.time()
                scalars["steps_per_sec"] = log_interval / max(now - t_last, 1e-6)
                t_last = now
                logger.write(step, scalars)
                log.info("epoch %d step %d %s", epoch, step, scalars)
            if step % save_interval == 0:
                ckpt_lib.save(ckpt_dir, state, step)
            if eval_fn is not None and eval_interval and step % eval_interval == 0:
                try:  # an eval failure is logged and training goes on
                    scalars = eval_fn(state, step, model_dir)
                    if scalars:
                        logger.write(step, {f"eval/{k}": v
                                            for k, v in scalars.items()})
                except Exception:
                    log.exception("eval_fn failed at step %d", step)
        ckpt_lib.save(ckpt_dir, state, state.step)
    return state
