"""Seeded weights for the four models, drawn on the device in two calls.

The rules are those of the port's nn/init.py, frozen here and keyed by the
reference modules' parameter names: convolutions and linear layers
N(0, (gain / fan_in)) with gain 0.5 for a kernel wider than one tap and for
every weight-normed or transposed convolution (fan_in Cin * K, divided by
the stride for a transposed one), weight_g the norm of weight_v, biases 0;
embeddings and relative-position tables N(0, 1 / width); LSTM weights and
bias_ih U(-1 / sqrt(H), 1 / sqrt(H)), bias_hh 0; the RVQ codebook N(0, 1);
snake alpha / beta 0; LayerNorm scales 1; the PLM's position scale 1. All
normal draws of a model come from one randn call and all uniform ones from
one rand call, float32 (the port serves float32 parameters in both of its
compute dtypes).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from portbench.reference import layers as L
from portbench.reference import models as M

GAIN = 0.5


def _rules(model: nn.Module):
    """(name, shape, kind, scale) for every parameter and buffer; kind is
    normal / uniform / zeros / ones / norm_of (scale: the v it is the norm
    of) / copy (scale: the name it copies)."""
    out = []
    for mname, m in model.named_modules():
        p = (mname + ".") if mname else ""
        own = dict(m.named_parameters(recurse=False))
        own.update(dict(m.named_buffers(recurse=False)))
        if not own:
            continue
        if isinstance(m, (L.Conv1d, L.Linear)):
            w = own["weight"]
            g = GAIN if w.dim() == 3 and w.shape[-1] > 1 else 1.0
            out.append((p + "weight", w.shape, "normal", g * w[0].numel() ** -0.5))
        elif isinstance(m, L.WNConv1d):
            v = own["weight_v"]
            out.append((p + "weight_v", v.shape, "normal", GAIN * v[0].numel() ** -0.5))
            out.append((p + "weight_g", own["weight_g"].shape, "norm_of", p + "weight_v"))
        elif isinstance(m, L.WNConvTranspose1d):
            v = own["weight_v"]
            cin, _, k = v.shape
            out.append((p + "weight_v", v.shape, "normal",
                        GAIN * (cin * k / m.stride) ** -0.5))
            out.append((p + "weight_g", own["weight_g"].shape, "norm_of", p + "weight_v"))
        elif isinstance(m, nn.Embedding):
            out.append((p + "weight", m.weight.shape, "normal", m.embedding_dim ** -0.5))
        elif isinstance(m, L.MultiHeadAttention):
            for n in ("emb_rel_k", "emb_rel_v"):
                t = own[n]
                out.append((p + n, t.shape, "normal", t.shape[-1] ** -0.5))
        elif isinstance(m, L.BiLSTM):
            for n, t in own.items():
                kind = "zeros" if n.startswith("bias_hh") else "uniform"
                out.append((p + n, t.shape, kind, m.hidden ** -0.5))
        elif isinstance(m, M._Codebook):
            out.append((p + "embed", own["embed"].shape, "normal", 1.0))
            out.append((p + "embed_avg", own["embed"].shape, "copy", p + "embed"))
            out.append((p + "inited", own["inited"].shape, "ones", None))
            out.append((p + "cluster_size", own["cluster_size"].shape, "zeros", None))
            continue
        elif isinstance(m, (L.AffineLayerNorm, L.LayerNorm)):
            for n, t in own.items():
                out.append((p + n, t.shape, "ones" if n in ("gamma", "weight") else "zeros", None))
            continue
        elif isinstance(m, M._PosEmb):
            out.append((p + "alpha", own["alpha"].shape, "ones", None))
            continue
        elif isinstance(m, L._Snake):
            for n, t in own.items():
                out.append((p + n, t.shape, "zeros", None))
            continue
        if "bias" in own and own["bias"] is not None:
            out.append((p + "bias", own["bias"].shape, "zeros", None))
    return out


def draw_state(model_cls, cfg: dict, seed: int, device) -> dict:
    """The state_dict of model_cls(cfg) drawn from `seed` on `device`."""
    with torch.device("meta"):
        rules = _rules(model_cls(cfg))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    numel = lambda s: int(np.prod(s))  # noqa: E731
    n_norm = sum(numel(s) for _, s, k, _ in rules if k == "normal")
    n_unif = sum(numel(s) for _, s, k, _ in rules if k == "uniform")
    normal = torch.randn(n_norm, generator=gen, device=device)
    unif = torch.rand(n_unif, generator=gen, device=device) * 2 - 1
    sd, i, j = {}, 0, 0
    for name, shape, kind, scale in rules:
        n = numel(shape)
        if kind == "normal":
            sd[name] = normal[i:i + n].view(shape) * scale
            i += n
        elif kind == "uniform":
            sd[name] = unif[j:j + n].view(shape) * scale
            j += n
        elif kind in ("zeros", "ones"):
            sd[name] = (torch.zeros if kind == "zeros" else torch.ones)(
                shape, device=device)
    for name, shape, kind, src in rules:
        if kind == "norm_of":
            v = sd[src]
            sd[name] = v.pow(2).sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
        elif kind == "copy":
            sd[name] = sd[src].clone()
    return sd


MODELS = {"ttv": M.TTV, "plm": M.PLM, "vocoder": M.Vocoder, "speechsr": M.SpeechSR}


def draw_all(cfg: dict, seed: int, device) -> dict:
    """{model: state_dict} of the configuration's four models; each model
    draws from its own stream of the seed."""
    seeds = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 7])
    subs = seeds.generate_state(len(MODELS), dtype=np.uint64)
    return {name: draw_state(cls, cfg[name], int(s) & ((1 << 63) - 1), device)
            for (name, cls), s in zip(MODELS.items(), subs)}
