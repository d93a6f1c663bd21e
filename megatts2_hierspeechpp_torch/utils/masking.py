"""Mask utilities on channels-last tensors.

Counterpart of `feature_mask` in `megatts2_hierspeechpp_tpu/utils/masking.py`.
"""
from __future__ import annotations

import torch


def feature_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) int lengths -> (B, T, 1) float {0, 1} mask."""
    pos = torch.arange(max_length, device=lengths.device)[None, :]
    return (pos < lengths[:, None])[:, :, None].float()
