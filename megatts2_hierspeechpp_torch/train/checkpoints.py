"""Checkpoints with latest-step resume and a retention policy.

Counterpart of `megatts2_hierspeechpp_tpu/train/checkpoints.py` (orbax
directories `step_XXXXXXXX`), in the port's own format: one `torch.save`
file `<base>/step_XXXXXXXX` holding the train state's state_dict. It is
written under a temporary name and renamed, so a crash never leaves a
partial checkpoint under a step's name. The newest `keep` are kept.
"""
from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

_NAME = re.compile(r"step_(\d+)")


def _ckpt_path(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:08d}")


def _steps(base: str) -> list[int]:
    if not os.path.isdir(base):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(base)
                  if (m := _NAME.fullmatch(name)))


def latest_step(base: str) -> Optional[int]:
    steps = _steps(base)
    return steps[-1] if steps else None


def save(base: str, state: Any, step: int, keep: int = 3) -> str:
    """torch.save(state.state_dict()) as `<base>/step_XXXXXXXX`; older
    checkpoints beyond the newest `keep` are deleted."""
    os.makedirs(base, exist_ok=True)
    path = _ckpt_path(base, step)
    tmp = os.path.join(base, f".step_{step:08d}.{os.getpid()}.tmp")
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)
    for old in _steps(base)[:-keep]:
        os.remove(_ckpt_path(base, old))
    return path


def restore_raw(base: str, step: Optional[int] = None) -> Optional[dict]:
    """The saved state_dict of the latest (or the given) step, on the CPU,
    or None if there is none."""
    step = latest_step(base) if step is None else step
    if step is None or not os.path.isfile(_ckpt_path(base, step)):
        return None
    return torch.load(_ckpt_path(base, step), map_location="cpu",
                      weights_only=True)


def restore(base: str, state: Any, step: Optional[int] = None) -> Any:
    """Load the latest (or the given) checkpoint into `state` (anything
    with load_state_dict) and return it; None if there is none."""
    saved = restore_raw(base, step)
    if saved is None:
        return None
    state.load_state_dict(saved)
    return state
