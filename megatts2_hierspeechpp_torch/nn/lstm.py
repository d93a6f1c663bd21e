"""Bidirectional LSTMs on channels-last (B, T, C) tensors.

Counterpart of `megatts2_hierspeechpp_tpu/nn/lstm.py` (BiLSTM /
StackedBiLSTM). Both are `torch.nn.LSTM(batch_first=True,
bidirectional=True)`, so their parameters are the reference checkpoint's
(`weight_ih_l{n}[_reverse]`, `weight_hh_l{n}[_reverse]`, `bias_ih_l{n}...`,
`bias_hh_l{n}...`). The JAX package keeps one bias b = b_ih + b_hh; the port
carries it as bias_ih = b, bias_hh = 0 (convert.py).

`length_aware=True` (the RangePredictor) packs the batch: the backward
direction starts at each sequence's last true frame and padding outputs are
zero. `length_aware=False` (the DurationPredictor) runs over the padded
batch, so the backward direction consumes the padding zeros, as in the
reference.

The JAX LSTM has one bias per gate, the port bias_ih = b and bias_hh = 0
(convert.py). bias_hh is left out of training (requires_grad False), so a
training build learns the one bias JAX learns: training both would move
their sum twice per step.

The LSTMs compute in float32 under a bf16 model as well: the JAX scan's
input projection promotes against its float32 weights, and every JAX
caller hands it float32 (the duration predictor's `x * x_mask`, the range
predictor's concatenation, both against float32 masks and durations), so
its carry is float32. A lower-precision input is taken to float32 here.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence


class StackedBiLSTM(nn.LSTM):
    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 length_aware: bool = False):
        super().__init__(input_size, hidden_size, num_layers,
                         batch_first=True, bidirectional=True)
        self.length_aware = length_aware
        for name, p in self.named_parameters():
            if name.startswith("bias_hh"):
                p.requires_grad_(False)

    def forward(self, x, lengths: Optional[torch.Tensor] = None):
        """x: (B, T, In); lengths: (B,) true lengths (used when
        length_aware) -> (B, T, 2H)."""
        x = x.float()
        t = x.shape[1]
        if not self.length_aware or lengths is None:
            return super().forward(x)[0]
        lens = torch.as_tensor(lengths).to("cpu", torch.int64)
        if bool((lens == t).all()):
            return super().forward(x)[0]
        packed = pack_padded_sequence(x, lens, batch_first=True,
                                      enforce_sorted=False)
        out, _ = super().forward(packed)
        return pad_packed_sequence(out, batch_first=True, total_length=t)[0]


def BiLSTM(input_size: int, hidden_size: int,
           length_aware: bool = True) -> StackedBiLSTM:
    """Single bidirectional layer, (B, T, In) -> (B, T, 2H)."""
    return StackedBiLSTM(input_size, hidden_size, 1, length_aware)
