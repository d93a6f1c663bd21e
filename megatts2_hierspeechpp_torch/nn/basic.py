"""Small shared building blocks on channels-last (B, T, C) tensors.

Counterpart of `megatts2_hierspeechpp_tpu/nn/basic.py`.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1

# torch.nn.Linear: weight (Out, In), the reference checkpoint's layout. The
# JAX Dense stores the transpose.
Dense = nn.Linear
# torch.nn.Embedding: weight (N, C), the JAX Embed's table.
Embed = nn.Embedding


class LayerNorm(nn.Module):
    """LayerNorm over the channel (last) axis without affine parameters (the
    DiT blocks' norm)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.channels, self.eps = channels, eps

    def forward(self, x):
        return F.layer_norm(x, (self.channels,), eps=self.eps)


class AffineLayerNorm(nn.Module):
    """LayerNorm over the channel (last) axis with a scale and a bias, named
    gamma / beta as in the reference's VITS modules.LayerNorm (the JAX
    LayerNorm's scale / bias)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.channels, self.eps = channels, eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.layer_norm(x, (self.channels,), self.gamma, self.beta,
                            self.eps)


def leaky_relu(x, slope: float = LRELU_SLOPE):
    return F.leaky_relu(x, slope)


def mish(x):
    return x * torch.tanh(F.softplus(x))


def gelu_tanh(x):
    """torch GELU(approximate='tanh')."""
    return F.gelu(x, approximate="tanh")


def fused_add_tanh_sigmoid_multiply(a, b, n: int):
    """WaveNet gate on channels-last tensors: split 2C into tanh/sigmoid
    halves (reference commons.fused_add_tanh_sigmoid_multiply)."""
    s = a + b
    return torch.tanh(s[..., :n]) * torch.sigmoid(s[..., n:])


# ---------- dropout ----------
#
# A JAX nn.Dropout site draws its keep mask from the "dropout" rng when the
# forward runs with deterministic=False. The port's Dropout draws only when
# its module is in train() mode AND a MaskSource is active
# (`with dropout_masks(source):`), the counterpart of passing that rng; in
# eval() mode, or with no source (the JAX vocoder trainer's deterministic
# forward), a site passes its input through and draws nothing.

_SOURCES: list = []


class MaskSource:
    """Keep masks for the dropout sites of one forward, in call order: drawn
    from `generator` (on the generator's device, then moved to the
    input's), or taken from `masks`, a list of bool keep masks (the tests
    feed the JAX forward's)."""

    def __init__(self, generator: torch.Generator | None = None, masks=None):
        if (generator is None) == (masks is None):
            raise ValueError("give a generator or a list of masks")
        self.generator = generator
        self.masks = None if masks is None else list(masks)

    def keep(self, shape, p: float, device) -> torch.Tensor:
        if self.masks is not None:
            if not self.masks:
                raise RuntimeError("more dropout sites than masks given")
            m = torch.as_tensor(self.masks.pop(0))
            if tuple(m.shape) != tuple(shape):
                raise ValueError(f"dropout mask {tuple(m.shape)} for an "
                                 f"input {tuple(shape)}")
            return m.to(device=device, dtype=torch.bool)
        g = self.generator
        return (torch.rand(shape, generator=g, device=g.device) < 1.0 - p).to(device)


@contextlib.contextmanager
def dropout_masks(source: MaskSource):
    """The dropout sites of training-mode modules draw from `source` inside
    this context."""
    _SOURCES.append(source)
    try:
        yield source
    finally:
        _SOURCES.remove(source)


class Dropout(nn.Module):
    """flax nn.Dropout(p): where(keep, x / (1 - p), 0) with keep ~
    Bernoulli(1 - p), from the active MaskSource (see above)."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = p

    def forward(self, x):
        if not self.training or self.p == 0.0 or not _SOURCES:
            return x
        keep = _SOURCES[-1].keep(x.shape, self.p, x.device)
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"p={self.p}"
