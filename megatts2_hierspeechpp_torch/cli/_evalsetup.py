"""The held-out batch of the training CLIs' periodic eval.

Counterpart of `megatts2_hierspeechpp_tpu/cli/_evalsetup.py` (reference
eval_loader over hps.data.validation_files, train_ms.py:179-184).
"""
from __future__ import annotations

import logging
import os

from megatts2_hierspeechpp_torch.data.dataset import (
    DatasetConfig,
    SidecarDataset,
    collate,
)

log = logging.getLogger("megatts2")


def make_eval_batch(hps, fallback, max_items: int = 4, cfg=None):
    """Collate up to `max_items` utterances of data.validation_files, or
    return `fallback` (the first training batch) when no validation list is
    usable: the hook observes, it selects no model. `cfg` is the training
    dataset's DatasetConfig, so validation items are filtered alike."""
    val = hps.data.get("validation_files", None)
    if val and os.path.exists(val):
        try:
            ds = SidecarDataset(val, cfg if cfg is not None else DatasetConfig())
            if len(ds):
                return collate([ds[i] for i in range(min(len(ds), max_items))])
        except Exception as e:  # noqa: BLE001 (logged; eval on the train batch)
            log.warning("validation_files unusable (%s); eval on train batch", e)
    return fallback
