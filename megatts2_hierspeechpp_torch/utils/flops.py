"""Model FLOPs of one call, counted by operator.

Counterpart of `megatts2_hierspeechpp_tpu/utils/flops.py`, which walks a
function's jaxpr counting dot_general and conv_general_dilated (a
transposed conv only at its nonzero taps). Here
torch.utils.flop_counter.FlopCounterMode counts the same operators as
they run: a matmul 2 M N K per batch element, a convolution 2 x output
elements x (Cin / groups) x kernel taps, a transposed convolution
2 x input elements x Cout / groups x kernel taps (its nonzero taps, as
JAX's count), attention's products; elementwise work is not counted, as
in JAX. A loop counts each iteration it runs (JAX multiplies a scan's
body by its length). Kernels of the port's own on a CUDA tensor are not
seen by the counter: count on the CPU, where the wrappers run their plain
versions.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.flop_counter import FlopCounterMode


def count_flops(fn: Callable, *args, **kwargs) -> int:
    """Matmul / convolution FLOPs of fn(*args, **kwargs), run once."""
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn(*args, **kwargs)
    return int(counter.get_total_flops())

