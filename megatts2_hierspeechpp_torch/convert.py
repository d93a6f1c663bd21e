"""Weight carry-over: JAX param trees -> the port's state_dicts.

`vocoder_from_jax(params)` and `speechsr_from_jax(params)` take the flax
param trees of the JAX HierVocoder / SpeechSR (nested dicts of arrays) and
return `state_dict`s for the port's modules, whose names are the reference
checkpoint's. Depths (WN layers, flows, DiT blocks, upsample stages,
resblocks) are read from the tree, so reduced test configurations convert
too.

Layouts (inverse of megatts2_hierspeechpp_tpu/utils/torch_compat.py):
  Conv1d kernel (K, Cin, Cout)             -> weight (Cout, Cin, K)
  WNConv1d v (K, Cin, Cout), g (Cout,)     -> weight_v (Cout, Cin, K), weight_g (Cout, 1, 1)
  WNConvTranspose1d v flipped (K, Cin, Cout), g (Cin,)
                                           -> weight_v (Cin, Cout, K), weight_g (Cin, 1, 1)
  Dense kernel (In, Out)                   -> Linear weight (Out, In), or a
                                              1x1 Conv1d weight (Out, In, 1)
"""
from __future__ import annotations

import re

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _k(p: str, name: str) -> str:
    """Join a (possibly empty) prefix and a name."""
    return f"{p}.{name}" if p else name


def _count(tree: dict, prefix: str) -> int:
    pat = re.compile(rf"{prefix}_(\d+)$")
    idx = [int(m.group(1)) for k in tree for m in [pat.match(k)] if m]
    return max(idx) + 1 if idx else 0


def _bias(out: dict, p: str, tree: dict) -> None:
    if "bias" in tree:
        out[_k(p, "bias")] = _t(tree["bias"])


def conv1d(out, p, tree):
    out[_k(p, "weight")] = _t(np.transpose(tree["kernel"], (2, 1, 0)))
    _bias(out, p, tree)


def conv1x1(out, p, tree):
    """JAX Dense standing for a reference 1x1 Conv1d."""
    out[_k(p, "weight")] = _t(np.transpose(tree["kernel"])[:, :, None])
    _bias(out, p, tree)


def linear(out, p, tree):
    out[_k(p, "weight")] = _t(np.transpose(tree["kernel"]))
    _bias(out, p, tree)


def wn_conv1d(out, p, tree):
    out[_k(p, "weight_g")] = _t(np.reshape(tree["g"], (-1, 1, 1)))
    out[_k(p, "weight_v")] = _t(np.transpose(tree["v"], (2, 1, 0)))
    _bias(out, p, tree)


def wn_conv_transpose1d(out, p, tree):
    out[_k(p, "weight_g")] = _t(np.reshape(tree["g"], (-1, 1, 1)))
    v = np.asarray(tree["v"])[::-1]  # unflip K
    out[_k(p, "weight_v")] = _t(np.transpose(v, (1, 2, 0)))
    _bias(out, p, tree)


def snake(out, p, tree):
    out[_k(p, "act.alpha")] = _t(tree["alpha"])
    out[_k(p, "act.beta")] = _t(tree["beta"])


def wn(out, p, tree):
    if "cond_layer" in tree:
        wn_conv1d(out, _k(p, "cond_layer"), tree["cond_layer"])
    for i in range(_count(tree, "in")):
        wn_conv1d(out, _k(p, f"in_layers.{i}"), tree[f"in_{i}"])
        wn_conv1d(out, _k(p, f"res_skip_layers.{i}"), tree[f"res_skip_{i}"])


def ampblock(out, p, tree):
    for i in range(_count(tree, "convs1")):
        wn_conv1d(out, _k(p, f"convs1.{i}"), tree[f"convs1_{i}"])
        wn_conv1d(out, _k(p, f"convs2.{i}"), tree[f"convs2_{i}"])
    for j in range(_count(tree, "act")):
        snake(out, _k(p, f"activations.{j}"), tree[f"act_{j}"])


def posterior_sf_encoder(out, p, tree):
    conv1x1(out, _k(p, "pre_source"), tree["pre_source"])
    conv1d(out, _k(p, "pre_filter"), tree["pre_filter"])
    for name in ("source_enc", "filter_enc", "enc"):
        wn(out, _k(p, name), tree[name])
    conv1x1(out, _k(p, "proj"), tree["proj"])


def dit_coupling_block(out, p, tree):
    linear(out, _k(p, "cond_block.0"), tree["cond_0"])
    linear(out, _k(p, "cond_block.2"), tree["cond_1"])
    for i in range(_count(tree, "flow")):
        fp, ft = _k(p, f"flows.{2 * i}"), tree[f"flow_{i}"]
        conv1d(out, _k(fp, "pre"), ft["pre"])
        conv1d(out, _k(fp, "post"), ft["post"])
        for j in range(_count(ft, "enc")):
            bp, bt = _k(fp, f"enc_block.{j}"), ft[f"enc_{j}"]
            linear(out, _k(bp, "attn.qkv"), bt["attn"]["qkv"])
            linear(out, _k(bp, "attn.proj"), bt["attn"]["proj"])
            conv1d(out, _k(bp, "mlp.fc1"), bt["mlp"]["fc1"])
            conv1d(out, _k(bp, "mlp.fc2"), bt["mlp"]["fc2"])
            linear(out, _k(bp, "adaLN_modulation.1"), bt["adaLN_modulation"])


def _upsampler(out, p, tree):
    """ups, resblocks, activation_post, conv_post of Generator/SourceNetwork."""
    for i in range(_count(tree, "ups")):
        wn_conv_transpose1d(out, _k(p, f"ups.{i}"), tree[f"ups_{i}"])
    for r in range(_count(tree, "resblocks")):
        ampblock(out, _k(p, f"resblocks.{r}"), tree[f"resblocks_{r}"])
    snake(out, _k(p, "activation_post"), tree["activation_post"])
    conv1d(out, _k(p, "conv_post"), tree["conv_post"])


def source_network(out, p, tree):
    wn_conv1d(out, _k(p, "conv_pre"), tree["conv_pre"])
    conv1x1(out, _k(p, "cond"), tree["cond"])
    _upsampler(out, p, tree)


def generator(out, p, tree):
    wn_conv1d(out, _k(p, "conv_pre"), tree["conv_pre"])
    wn_conv1d(out, _k(p, "downs.residual_dense"), tree["downs"]["residual_dense"])
    for i in range(3):
        wn_conv1d(out, _k(p, f"downs.conv.{i}"), tree["downs"][f"conv_{i}"])
    conv1x1(out, _k(p, "cond"), tree["cond"])
    conv1d(out, _k(p, "proj"), tree["proj"])
    _upsampler(out, p, tree)


def style_encoder(out, p, tree):
    conv1x1(out, _k(p, "spectral.0"), tree["spectral_0"])
    conv1x1(out, _k(p, "spectral.3"), tree["spectral_1"])
    conv1d(out, _k(p, "temporal.0.conv1"), tree["temporal_0"]["conv1"])
    conv1d(out, _k(p, "temporal.1.conv1"), tree["temporal_1"]["conv1"])
    for name in ("conv_q", "conv_k", "conv_v", "conv_o"):
        conv1x1(out, _k(p, f"slf_attn.{name}"), tree["slf_attn"][name])
    conv1x1(out, _k(p, "fc"), tree["fc"])


def vocoder_from_jax(params: dict) -> dict:
    """JAX HierVocoder params (inference members) -> port state_dict."""
    out = {}
    posterior_sf_encoder(out, "enc_p_l", params["enc_p_l"])
    dit_coupling_block(out, "flow_l", params["flow_l"])
    dit_coupling_block(out, "flow", params["flow"])
    generator(out, "dec", params["dec"])
    source_network(out, "sn", params["sn"])
    style_encoder(out, "emb_g", params["emb_g"])
    return out


def speechsr_from_jax(params: dict) -> dict:
    """JAX SpeechSR params -> port state_dict."""
    out = {}
    wn_conv1d(out, "conv_pre", params["conv_pre"])
    for j in range(_count(params, "resblocks")):
        ampblock(out, f"resblocks.{j}", params[f"resblocks_{j}"])
    snake(out, "activation_post", params["activation_post"])
    conv1d(out, "conv_post", params["conv_post"])
    return out
