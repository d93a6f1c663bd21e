"""Weight carry-over: JAX param trees -> the port's state_dicts.

`vocoder_from_jax(params)` (with the training members when the tree has
them: a JAX `init_all` tree), `mpd_from_jax(params)` (the vocoder's
MultiPeriodDiscriminator), `mrsd_from_jax({"params", "spectral"})` (the s2
trainer's MultiResSpecDiscriminator), `speechsr_from_jax(params)`,
`ttv_from_jax({"params", "vq"})`, `plm_from_jax(params)`,
`plm_noncausal_from_jax(params)` (ProsodyLMNonCausal),
`wav2vec2_from_jax(params)`, `denoiser_from_jax({"params",
"batch_stats"})`, `t2s_from_jax(params)` (Text2Semantic),
`hubert_from_jax(params)`, `gpt_prosody_from_jax(params)` and
`dvae_from_jax({"params", "vq"})` take the flax variables of the JAX
HierVocoder / SpeechSR / TTVModel / ProsodyLM / Wav2Vec2 / MPNet /
Text2Semantic / Hubert / GPTProsody / DiscreteVAE (nested dicts of arrays)
and return `state_dict`s for the port's modules, whose names are the
reference checkpoint's (HF Wav2Vec2Model's / HubertModel's for the SSL
models; the JAX tree's for the GPT stack, which has no reference names). Depths (WN layers, flows,
DiT blocks, upsample stages, resblocks, encoder and LSTM layers, PLM
layers, w2v layers, TS conformer blocks) are read from the tree, so
reduced test configurations convert too.

Layouts (inverse of megatts2_hierspeechpp_tpu/utils/torch_compat.py):
  Conv1d kernel (K, Cin, Cout)             -> weight (Cout, Cin, K)
  WNConv1d v (K, Cin, Cout), g (Cout,)     -> weight_v (Cout, Cin, K), weight_g (Cout, 1, 1)
  WNConvTranspose1d v flipped (K, Cin, Cout), g (Cin,)
                                           -> weight_v (Cin, Cout, K), weight_g (Cin, 1, 1)
  Dense kernel (In, Out)                   -> Linear weight (Out, In), or a
                                              1x1 Conv1d weight (Out, In, 1)
  LayerNorm scale, bias                    -> gamma, beta (VITS) or weight, bias
  LSTM w_ih (In, 4H), w_hh (H, 4H), b      -> weight_ih (4H, In), weight_hh (4H, H),
                                              bias_ih = b, bias_hh = 0
  Conv2d kernel (Kh, Kw, Cin, Cout)        -> weight (Cout, Cin, Kh, Kw)
  WNConv2d v (Kh, Kw, Cin, Cout), g (Cout,) -> weight_v (Cout, Cin, Kh, Kw),
                                              weight_g (Cout, 1, 1, 1)
  SNConv2d kernel (Kh, Kw, Cin, Cout), spectral u, v
                                           -> weight_orig (Cout, Cin, Kh, Kw),
                                              weight_u, weight_v
  ConvTranspose2d (1, 3) up_kernel flipped (3, Cin, Cout)
                                           -> weight (Cin, Cout, 1, 3)
  ConvTranspose1d kernel flipped (K, Cin, Cout)
                                           -> weight (Cin, Cout, K)
  fused w2v pos_conv kernel (K, Cin/g, Cout)
                                           -> weight_v (Cout, Cin/g, K) = w,
                                              weight_g (1, 1, K) = ||w|| over Cout, Cin/g
  BatchNorm batch_stats mean, var          -> running_mean, running_var
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


def posterior_audio_encoder(out, p, tree):
    conv1d(out, _k(p, "down_pre"), tree["down_pre"])
    for i in range(_count(tree, "downs")):
        wn_conv1d(out, _k(p, f"downs.{i}"), tree[f"downs_{i}"])
    for r in range(_count(tree, "resblocks")):
        ampblock(out, _k(p, f"resblocks.{r}"), tree[f"resblocks_{r}"])
    snake(out, _k(p, "activation_post"), tree["activation_post"])
    conv1d(out, _k(p, "conv_post"), tree["conv_post"])
    conv1x1(out, _k(p, "pre"), tree["pre"])
    wn(out, _k(p, "enc"), tree["enc"])
    conv1x1(out, _k(p, "proj"), tree["proj"])


def mel_decoder(out, p, tree):
    conv1d(out, _k(p, "conv_pre"), tree["conv_pre"])
    conv1x1(out, _k(p, "cond"), tree["cond"])
    vits_encoder(out, _k(p, "encoder"), tree["encoder"])
    conv1x1(out, _k(p, "proj"), tree["proj"])


def vocoder_from_jax(params: dict) -> dict:
    """JAX HierVocoder params -> port state_dict: the inference members, and
    the training members (enc_p, enc_q, mel_decoder) when the tree has them
    (one made by the JAX `init_all`), for a `HierVocoder(train=True)`."""
    out = {}
    posterior_sf_encoder(out, "enc_p_l", params["enc_p_l"])
    dit_coupling_block(out, "flow_l", params["flow_l"])
    dit_coupling_block(out, "flow", params["flow"])
    generator(out, "dec", params["dec"])
    source_network(out, "sn", params["sn"])
    style_encoder(out, "emb_g", params["emb_g"])
    if "enc_q" in params:
        posterior_sf_encoder(out, "enc_p", params["enc_p"])
        posterior_audio_encoder(out, "enc_q", params["enc_q"])
        mel_decoder(out, "mel_decoder", params["mel_decoder"])
    return out


def wn_conv2d(out, p, tree):
    out[_k(p, "weight_g")] = _t(np.reshape(tree["g"], (-1, 1, 1, 1)))
    out[_k(p, "weight_v")] = _t(np.transpose(tree["v"], (3, 2, 0, 1)))
    _bias(out, p, tree)


def _discriminator(out, p, tree):
    for j in range(_count(tree, "convs")):
        wn_conv2d(out, _k(p, f"convs.{j}"), tree[f"convs_{j}"])
    wn_conv2d(out, _k(p, "conv_post"), tree["conv_post"])


def mpd_from_jax(params: dict) -> dict:
    """JAX MultiPeriodDiscriminator params -> port state_dict: `disc_r_{i}`
    at `discriminators.{i}`, then `disc_p_{i}` after them."""
    out = {}
    n_r = _count(params, "disc_r")
    for i in range(n_r):
        _discriminator(out, f"discriminators.{i}", params[f"disc_r_{i}"])
    for i in range(_count(params, "disc_p")):
        _discriminator(out, f"discriminators.{n_r + i}", params[f"disc_p_{i}"])
    return out


def mrsd_from_jax(variables: dict) -> dict:
    """JAX MultiResSpecDiscriminator variables {"params", "spectral"} ->
    port state_dict: `disc_{i}` at `discriminators.{i}`, its `convs_{j}`
    at `.discriminators.{j}`; spectral-normalised where the tree has the
    spectral state (disc_0), else weight-normalised."""
    params, spectral, out = variables["params"], variables.get("spectral", {}), {}
    for i in range(_count(params, "disc")):
        tree, p = params[f"disc_{i}"], f"discriminators.{i}"
        sn = spectral.get(f"disc_{i}")
        names = [f"convs_{j}" for j in range(_count(tree, "convs"))] + ["out"]
        for name in names:
            q = f"{p}.discriminators.{name[6:]}" if name != "out" else f"{p}.out"
            if sn is None:
                wn_conv2d(out, q, tree[name])
                continue
            conv2d(out, q, tree[name], weight="weight_orig")
            out[f"{q}.weight_u"] = _t(sn[name]["u"])
            out[f"{q}.weight_v"] = _t(sn[name]["v"])
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


# ---------- acoustic stage: TTV and the prosody LM ----------


def embedding(out, p, tree):
    out[_k(p, "weight")] = _t(tree["embedding"])


def layer_norm(out, p, tree, names=("gamma", "beta")):
    out[_k(p, names[0])] = _t(tree["scale"])
    out[_k(p, names[1])] = _t(tree["bias"])


def mha(out, p, tree):
    for name in ("conv_q", "conv_k", "conv_v", "conv_o"):
        conv1x1(out, _k(p, name), tree[name])
    for name in ("emb_rel_k", "emb_rel_v"):
        if name in tree:
            out[_k(p, name)] = _t(tree[name])


def vits_encoder(out, p, tree):
    for i in range(_count(tree, "attn")):
        mha(out, _k(p, f"attn_layers.{i}"), tree[f"attn_{i}"])
        layer_norm(out, _k(p, f"norm_layers_1.{i}"), tree[f"norm1_{i}"])
        conv1d(out, _k(p, f"ffn_layers.{i}.conv_1"), tree[f"ffn_{i}"]["conv_1"])
        conv1d(out, _k(p, f"ffn_layers.{i}.conv_2"), tree[f"ffn_{i}"]["conv_2"])
        layer_norm(out, _k(p, f"norm_layers_2.{i}"), tree[f"norm2_{i}"])


def bilstm(out, p, tree, layer: int = 0):
    """JAX BiLSTM (w_ih (In, 4H), w_hh (H, 4H), one bias b) -> torch LSTM
    layer `layer`: bias_ih = b, bias_hh = 0."""
    for d, suffix in (("fwd", ""), ("bwd", "_reverse")):
        out[_k(p, f"weight_ih_l{layer}{suffix}")] = _t(np.transpose(tree[f"w_ih_{d}"]))
        out[_k(p, f"weight_hh_l{layer}{suffix}")] = _t(np.transpose(tree[f"w_hh_{d}"]))
        b = _t(tree[f"b_{d}"])
        out[_k(p, f"bias_ih_l{layer}{suffix}")] = b
        out[_k(p, f"bias_hh_l{layer}{suffix}")] = torch.zeros_like(b)


def resblock1(out, p, tree):
    for i in range(_count(tree, "convs1")):
        wn_conv1d(out, _k(p, f"convs1.{i}"), tree[f"convs1_{i}"])
        wn_conv1d(out, _k(p, f"convs2.{i}"), tree[f"convs2_{i}"])


def ttv_from_jax(ttv_vars: dict) -> dict:
    """JAX TTVModel variables {"params", "vq"} -> port state_dict."""
    params, out = ttv_vars["params"], {}
    enc_p = params["enc_p"]
    for name in ("emb", "emb_tone", "emb_language"):
        embedding(out, f"enc_p.{name}", enc_p[name])
    vits_encoder(out, "enc_p.encoder", enc_p["encoder"])
    vits_encoder(out, "enc_p.encoder2", enc_p["encoder2"])
    vits_encoder(out, "mel_encoder.encoder", params["mel_encoder"]["encoder"])
    conv1x1(out, "mel_encoder.proj", params["mel_encoder"]["proj"])
    mha(out, "mha", params["mha"])
    conv1x1(out, "cond_g", params["cond_g"])
    w2v_enc = params["w2v_encoder"]
    conv1x1(out, "w2v_encoder.cond", w2v_enc["cond"])
    vits_encoder(out, "w2v_encoder.encoder", w2v_enc["encoder"])
    vits_encoder(out, "w2v_encoder.encoder2", w2v_enc["encoder2"])
    w2v_dec = params["w2v_decoder"]
    conv1x1(out, "w2v_decoder.pre", w2v_dec["pre"])
    wn(out, "w2v_decoder.enc", w2v_dec["enc"])
    conv1x1(out, "w2v_decoder.proj", w2v_dec["proj"])
    style_encoder(out, "emb_g", params["emb_g"])
    dp = params["duration_predictor"]
    conv1x1(out, "duration_predictor.cond", dp["cond"])
    for i in range(_count(dp["lstms"], "layer")):
        bilstm(out, "duration_predictor.lstms", dp["lstms"][f"layer_{i}"], i)
    layer_norm(out, "duration_predictor.norm_2", dp["norm_2"])
    conv1x1(out, "duration_predictor.proj", dp["proj"])
    rp = params["range_predictor"]
    bilstm(out, "RangePredictor.lstm", rp["lstm"])
    linear(out, "RangePredictor.proj.linear_layer", rp["proj"])
    conv1d(out, "dur_downsample", params["dur_downsample"])
    pp = params["pp"]
    conv1d(out, "pp.conv_pre", pp["conv_pre"])
    conv1x1(out, "pp.cond", pp["cond"])
    for i in range(_count(pp, "ups")):
        wn_conv_transpose1d(out, f"pp.ups.{i}", pp[f"ups_{i}"])
    for r in range(_count(pp, "resblocks")):
        resblock1(out, f"pp.resblocks.{r}", pp[f"resblocks_{r}"])
    conv1d(out, "pp.conv_post", pp["conv_post"])
    for name in ("plm_conv1", "plm_conv2"):
        conv1d(out, f"{name}.conv1", params[name]["conv1"])
        conv1d(out, f"{name}.conv2", params[name]["conv2"])
    conv1x1(out, "ssl_proj", params["ssl_proj"])
    vq = ttv_vars["vq"]["quantizer"]
    for i in range(_count(vq, "vq")):
        cb, p = vq[f"vq_{i}"]["codebook"], f"quantizer.vq.layers.{i}._codebook"
        out[f"{p}.inited"] = _t(np.reshape(cb["inited"], (1,)))
        for name in ("cluster_size", "embed", "embed_avg"):
            out[f"{p}.{name}"] = _t(cb[name])
    return out


def plm_from_jax(params: dict) -> dict:
    """JAX ProsodyLM params -> port state_dict."""
    out = {}
    embedding(out, "pc_embedding", params["pc_embedding"])
    out["pos_emb.alpha"] = _t(params["pos_alpha"])
    for i in range(_count(params, "layer")):
        tree, p = params[f"layer_{i}"], f"plm.layers.{i}"
        layer_norm(out, f"{p}.norm1", tree["norm1"], ("weight", "bias"))
        layer_norm(out, f"{p}.norm2", tree["norm2"], ("weight", "bias"))
        for name in ("w_q", "w_k", "w_v"):
            linear(out, f"{p}.attn.{name}", tree[name])
        linear(out, f"{p}.attn.out_proj.0", tree["out_proj"])
        linear(out, f"{p}.ff.0", tree["ff_0"])
        linear(out, f"{p}.ff.3", tree["ff_1"])
    linear(out, "predict_layer", params["predict_layer"])
    return out


def plm_noncausal_from_jax(params: dict) -> dict:
    """JAX ProsodyLMNonCausal params -> port state_dict (reference
    Megatts2PLM: the VITS encoder at `plm`)."""
    out = {}
    embedding(out, "pc_embedding", params["pc_embedding"])
    out["pos_emb.alpha"] = _t(params["pos_alpha"])
    vits_encoder(out, "plm", params["plm"])
    linear(out, "predict_layer", params["predict_layer"])
    return out


# ---------- vc front-end (Wav2Vec2) and the denoiser (MPNet) ----------


def fuse_pos_conv(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The positional conv's weight norm (torch weight_norm dim=2): w = g *
    v / |v|, the norm over (Cout, Cin / groups), as JAX convert_wav2vec2
    fuses it."""
    norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
    return g * v / norm


def pos_conv_weight_norm(out, p, w):
    """A fused (Cout, Cin / groups, K) positional-conv weight as the port's
    weight norm: v = w, g = |w| over (Cout, Cin / groups)."""
    out[f"{p}.weight_v"] = _t(w)
    out[f"{p}.weight_g"] = _t(np.sqrt((w ** 2).sum(axis=(0, 1), keepdims=True)))


def wav2vec2_from_jax(params: dict) -> dict:
    """JAX Wav2Vec2 params -> port state_dict (HF Wav2Vec2Model names)."""
    out = {}
    fe = params["feature_extractor"]
    for i in range(_count(fe, "conv")):
        p = f"feature_extractor.conv_layers.{i}"
        conv1d(out, f"{p}.conv", fe[f"conv_{i}"])
        layer_norm(out, f"{p}.layer_norm", fe[f"ln_{i}"], ("weight", "bias"))
    layer_norm(out, "feature_projection.layer_norm", params["fp_ln"],
               ("weight", "bias"))
    linear(out, "feature_projection.projection", params["fp_proj"])
    w = np.transpose(np.asarray(params["pos_conv"]["kernel"], np.float32),
                     (2, 1, 0))
    p = "encoder.pos_conv_embed.conv"
    pos_conv_weight_norm(out, p, w)
    out[f"{p}.bias"] = _t(params["pos_conv"]["bias"])
    for i in range(_count(params, "layer")):
        tree, p = params[f"layer_{i}"], f"encoder.layers.{i}"
        layer_norm(out, f"{p}.layer_norm", tree["attn_ln"], ("weight", "bias"))
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(out, f"{p}.attention.{name}", tree["attn"][name])
        layer_norm(out, f"{p}.final_layer_norm", tree["ffn_ln"],
                   ("weight", "bias"))
        linear(out, f"{p}.feed_forward.intermediate_dense", tree["ff1"])
        linear(out, f"{p}.feed_forward.output_dense", tree["ff2"])
    return out


def conv2d(out, p, tree, weight: str = "weight"):
    out[_k(p, weight)] = _t(np.transpose(tree["kernel"], (3, 2, 0, 1)))
    _bias(out, p, tree)


def _norm_act(out, p, i, tree, norm, act):
    """InstanceNorm2d at `{p}.{i}`, PReLU at `{p}.{i + 1}`."""
    out[f"{p}.{i}.weight"] = _t(tree[norm]["scale"])
    out[f"{p}.{i}.bias"] = _t(tree[norm]["bias"])
    out[f"{p}.{i + 1}.weight"] = _t(tree[act]["alpha"])


def _dense_block(out, p, tree):
    for i in range(_count(tree, "conv")):
        conv2d(out, f"{p}.dense_block.{i}.0", tree[f"conv_{i}"])
        _norm_act(out, f"{p}.dense_block.{i}", 1, tree, f"norm_{i}", f"act_{i}")


def _conv_transpose2d_1x3(out, p, tree):
    w = np.asarray(tree["up_kernel"])[::-1]  # unflip: (3, Cin, Cout)
    out[f"{p}.weight"] = _t(np.transpose(w, (1, 2, 0))[:, :, None, :])
    out[f"{p}.bias"] = _t(tree["up_bias"])


def _conformer(out, p, tree, stats):
    for ffm in ("ffm1", "ffm2"):
        layer_norm(out, f"{p}.{ffm}.ffm.0", tree[ffm]["norm"], ("weight", "bias"))
        linear(out, f"{p}.{ffm}.ffm.1", tree[ffm]["fc1"])
        linear(out, f"{p}.{ffm}.ffm.4", tree[ffm]["fc2"])
    layer_norm(out, f"{p}.attn.layernorm", tree["attn_norm"], ("weight", "bias"))
    attn = tree["attn"]
    out[f"{p}.attn.attn.in_proj_weight"] = _t(attn["in_proj_weight"])
    out[f"{p}.attn.attn.in_proj_bias"] = _t(attn["in_proj_bias"])
    linear(out, f"{p}.attn.attn.out_proj", attn["out_proj"])
    ccm, c = tree["ccm"], f"{p}.ccm.ccm"
    layer_norm(out, f"{c}.0", ccm["norm"], ("weight", "bias"))
    conv1d(out, f"{c}.2", ccm["pw1"])
    conv1d(out, f"{c}.4", ccm["dw"])
    layer_norm(out, f"{c}.5", ccm["bn"], ("weight", "bias"))
    out[f"{c}.5.running_mean"] = _t(stats["ccm"]["bn"]["mean"])
    out[f"{c}.5.running_var"] = _t(stats["ccm"]["bn"]["var"])
    out[f"{c}.5.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    conv1d(out, f"{c}.7", ccm["pw2"])
    layer_norm(out, f"{p}.post_norm", tree["post_norm"], ("weight", "bias"))


def denoiser_from_jax(variables: dict) -> dict:
    """JAX MPNet variables {"params", "batch_stats"} -> port state_dict."""
    params, stats, out = variables["params"], variables["batch_stats"], {}
    enc = params["dense_encoder"]
    conv2d(out, "dense_encoder.dense_conv_1.0", enc["conv1"])
    _norm_act(out, "dense_encoder.dense_conv_1", 1, enc, "norm1", "act1")
    _dense_block(out, "dense_encoder.dense_block", enc["dense"])
    conv2d(out, "dense_encoder.dense_conv_2.0", enc["conv2"])
    _norm_act(out, "dense_encoder.dense_conv_2", 1, enc, "norm2", "act2")
    for i in range(_count(params, "ts")):
        for jname, name in (("time", "time_conformer"), ("freq", "freq_conformer")):
            _conformer(out, f"TSConformer.{i}.{name}", params[f"ts_{i}"][jname],
                       stats[f"ts_{i}"][jname])
    md = params["mask_decoder"]
    _dense_block(out, "mask_decoder.dense_block", md["dense"])
    _conv_transpose2d_1x3(out, "mask_decoder.mask_conv.0", md)
    conv2d(out, "mask_decoder.mask_conv.1", md["conv1"])
    _norm_act(out, "mask_decoder.mask_conv", 2, md, "norm", "act")
    conv2d(out, "mask_decoder.mask_conv.4", md["conv2"])
    out["mask_decoder.lsigmoid.slope"] = _t(
        np.reshape(md["lsigmoid"]["slope"], (-1, 1)))
    pd = params["phase_decoder"]
    _dense_block(out, "phase_decoder.dense_block", pd["dense"])
    _conv_transpose2d_1x3(out, "phase_decoder.phase_conv.0", pd)
    _norm_act(out, "phase_decoder.phase_conv", 1, pd, "norm", "act")
    conv2d(out, "phase_decoder.phase_conv_r", pd["conv_r"])
    conv2d(out, "phase_decoder.phase_conv_i", pd["conv_i"])
    return out


# ---------- the AR stack (Text2Semantic) and its SSL front end (Hubert) ----------


def t2s_from_jax(params: dict) -> dict:
    """JAX Text2Semantic params -> port state_dict (the reference
    Text2SemanticDecoder's names, the inverse of JAX convert_t2s)."""
    ln = ("weight", "bias")
    out = {}
    linear(out, "bert_proj", params["bert_proj"])
    for side in ("text", "audio"):
        embedding(out, f"ar_{side}_embedding.word_embeddings",
                  params[f"ar_{side}_embedding"])
        out[f"ar_{side}_position.alpha"] = _t(params[f"{side}_pos_alpha"])
    linear(out, "ar_predict_layer", params["ar_predict_layer"])
    for i in range(_count(params, "layer")):
        tree, p = params[f"layer_{i}"], f"h.layers.{i}"
        out[f"{p}.self_attn.in_proj_weight"] = _t(tree["in_proj_weight"])
        out[f"{p}.self_attn.in_proj_bias"] = _t(tree["in_proj_bias"])
        linear(out, f"{p}.self_attn.out_proj", tree["out_proj"])
        linear(out, f"{p}.linear1", tree["linear1"])
        linear(out, f"{p}.linear2", tree["linear2"])
        layer_norm(out, f"{p}.norm1", tree["norm1"], ln)
        layer_norm(out, f"{p}.norm2", tree["norm2"], ln)
    return out


def hubert_from_jax(params: dict) -> dict:
    """JAX Hubert params -> port state_dict (HF HubertModel names; the
    fused positional conv as v = w, g = |w|)."""
    ln = ("weight", "bias")
    out = {}
    fe = params["feature_extractor"]
    for i in range(_count(fe, "conv")):
        conv1d(out, f"feature_extractor.conv_layers.{i}.conv", fe[f"conv_{i}"])
    layer_norm(out, "feature_extractor.conv_layers.0.layer_norm", fe["gn_0"], ln)
    layer_norm(out, "feature_projection.layer_norm", params["fp_ln"], ln)
    linear(out, "feature_projection.projection", params["fp_proj"])
    w = np.transpose(np.asarray(params["pos_conv"]["kernel"], np.float32),
                     (2, 1, 0))
    p = "encoder.pos_conv_embed.conv"
    pos_conv_weight_norm(out, p, w)
    out[f"{p}.bias"] = _t(params["pos_conv"]["bias"])
    layer_norm(out, "encoder.layer_norm", params["enc_ln"], ln)
    for i in range(_count(params, "layer")):
        tree, p = params[f"layer_{i}"], f"encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(out, f"{p}.attention.{name}", tree["attn"][name])
        layer_norm(out, f"{p}.layer_norm", tree["attn_ln"], ln)
        linear(out, f"{p}.feed_forward.intermediate_dense", tree["ff1"])
        linear(out, f"{p}.feed_forward.output_dense", tree["ff2"])
        layer_norm(out, f"{p}.final_layer_norm", tree["ffn_ln"], ln)
    return out


# ---------- the GPT prosody stack (GPTProsody, DiscreteVAE) ----------


def conv_transpose1d(out, p, tree):
    """A plain ConvTranspose1d: the flipped (K, Cin, Cout) kernel ->
    weight (Cin, Cout, K)."""
    out[_k(p, "weight")] = _t(np.transpose(np.asarray(tree["kernel"])[::-1],
                                           (1, 2, 0)))
    _bias(out, p, tree)


def gpt_prosody_from_jax(params: dict) -> dict:
    """JAX GPTProsody params -> the port's state_dict (names after the JAX
    tree: h_{i} -> h.{i}, attn_{i} -> attn.{i}, scale -> weight)."""
    ln = ("weight", "bias")
    out = {}
    ce = params["cond_encoder"]
    conv1d(out, "cond_encoder.init", ce["init"])
    for i in range(_count(ce, "attn")):
        tree, p = ce[f"attn_{i}"], f"cond_encoder.attn.{i}"
        layer_norm(out, f"{p}.norm", tree["norm"], ln)
        conv1d(out, f"{p}.qkv", tree["qkv"])
        conv1d(out, f"{p}.proj_out", tree["proj_out"])
    embedding(out, "text_emb", params["text_emb"])
    embedding(out, "mel_emb", params["mel_emb"])
    out["text_pos"] = _t(params["text_pos"])
    out["mel_pos"] = _t(params["mel_pos"])
    for i in range(_count(params, "h")):
        tree, p = params[f"h_{i}"], f"h.{i}"
        for name in ("ln_1", "ln_2"):
            layer_norm(out, f"{p}.{name}", tree[name], ln)
        for name in ("c_attn", "c_proj", "mlp_fc", "mlp_proj"):
            linear(out, f"{p}.{name}", tree[name])
    layer_norm(out, "ln_f", params["ln_f"], ln)
    linear(out, "mel_head", params["mel_head"])
    return out


def dvae_from_jax(variables: dict) -> dict:
    """JAX DiscreteVAE variables {"params", "vq"} -> the port's state_dict
    (enc_{i} -> enc.{i}, dec_{i} -> dec.{i}; the codebook's EMA buffers)."""
    params, vq = variables["params"], variables["vq"]["codebook"]
    out = {}
    for i in range(_count(params, "enc")):
        conv1d(out, f"enc.{i}", params[f"enc_{i}"])
    for name in ("enc_out", "dec_in", "dec_out"):
        conv1d(out, name, params[name])
    for i in range(_count(params, "dec")):
        conv_transpose1d(out, f"dec.{i}", params[f"dec_{i}"])
    out["codebook.inited"] = _t(np.reshape(np.asarray(vq["inited"], np.float32), (1,)))
    for name in ("cluster_size", "embed", "embed_avg"):
        out[f"codebook.{name}"] = _t(vq[name])
    return out
