"""The controls: the reference with each model one precision below the one
the configuration states for it. Float32 with TF32 off goes down to TF32
(the card's TF32 tensor-core products for every matmul and cuDNN
convolution); bf16 goes down to fp8: every product's operands rounded to
float8 e4m3 with a per-tensor scale (amax / 448), as a scaled fp8 GEMM
takes them. Both configurations state the prosody LM's served decode in
bf16 (weights and cache), so its control is fp8 in both."""
from __future__ import annotations

import contextlib

import torch

from portbench.reference.layers import lowered

E4M3_MAX = 448.0


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


@contextlib.contextmanager
def tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8():
    return lowered(fp8_e4m3)


BELOW = {"float32": tf32, "bfloat16": fp8}


def control(cfg: dict) -> dict:
    """Per model, the context that runs it one precision below the
    configuration's."""
    low = BELOW[cfg["compute_dtype"]]
    return {"ttv": low, "vocoder": low, "speechsr": low,
            "plm": BELOW[cfg["decode_dtype"]]}
