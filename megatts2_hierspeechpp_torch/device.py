"""Device selection for the port's entry points.

Entry points default to the card. They raise when CUDA is absent instead of
moving to the CPU; callers that want the CPU (the tests) ask for it.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return `device` as a torch.device, checked to be usable.

    On CUDA this also turns TF32 off for matmuls and cuDNN convolutions: the
    port computes in full float32, like the JAX reference at
    Precision.HIGHEST.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
