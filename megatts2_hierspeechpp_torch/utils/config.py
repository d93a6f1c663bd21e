"""JSON configs with attribute access.

The port's copy of `megatts2_hierspeechpp_tpu/utils/config.py`: the field
names of the reference configs (reference utils.HParams), so a config file
serves both packages unchanged.
"""
from __future__ import annotations

import json
import os
from typing import Any, Mapping


class HParams(dict):
    """Recursive attribute-access dict (reference utils.HParams)."""

    def __init__(self, **kwargs: Any):
        super().__init__()
        for k, v in kwargs.items():
            if isinstance(v, Mapping):
                v = HParams(**v)
            self[k] = v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def copy(self) -> "HParams":
        return HParams(**self)

    def to_dict(self) -> dict:
        return {k: (v.to_dict() if isinstance(v, HParams) else v)
                for k, v in self.items()}


def load_hparams(path: str) -> HParams:
    with open(path, "r") as f:
        return HParams(**json.load(f))


def save_hparams(hps: HParams, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(hps.to_dict(), f, indent=2)
