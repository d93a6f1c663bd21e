"""The port's GPT prosody stack (models/plm_gpt.py) against the JAX package
on the CPU, JAX params carried over by convert.gpt_prosody_from_jax /
dvae_from_jax:

  - GPTProsody's training forward (loss and logits) at width 64 (GroupNorm
    of 32 groups in the conditioning encoder) and 48 (one group), and its
    gradients;
  - gpt_generate's tokens and lengths equal to JAX's, fed the JAX Gumbel
    noise, at top_k 50 and 0 (the full vocabulary), and a row that draws
    the stop token; the KV-cached decode against a full-prefix recompute;
  - DiscreteVAE's encode (codes equal), decode, training forward (recon,
    commit, loss) and its EMA step of the codebook statistics.

Small configuration: GPTProsody 2 layers, 4 heads, the default vocabularies
and position tables; DiscreteVAE 32 channels, codebook 64 x 16. Seeded
random params (tests/test_torch_wav2vec2.random_vars). Tolerances: loss
1e-5 relative, logits and DVAE outputs 1e-5 x max|ref|, gradients 1e-4
relative L2, tokens and codes exact."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megatts2_hierspeechpp_torch.convert import dvae_from_jax, gpt_prosody_from_jax
from megatts2_hierspeechpp_torch.models import plm_gpt as tgpt
from megatts2_hierspeechpp_torch.nn.decode import FedNoise
from megatts2_hierspeechpp_tpu.models import plm_gpt as jgpt
from tests.test_torch_ar import jax_noise, rel_l2
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_wav2vec2 import random_vars

SMALL = dict(n_layers=2, n_heads=4)
NM, NT, TC = 12, 7, 20      # mel tokens, text tokens, prompt frames


def gpt_inputs(b=2, seed=0):
    rng = np.random.default_rng(seed)
    return dict(cond_mel=rng.standard_normal((b, TC, 80)).astype(np.float32),
                text_ids=rng.integers(0, 256, (b, NT)).astype(np.int32),
                mel_tokens=rng.integers(0, 1024, (b, NM)).astype(np.int32),
                mel_lens=np.array([NM, 8][:b], np.int32))


def gpt_pair(dim, seed=1):
    jm = jgpt.GPTProsody(dim=dim, **SMALL)
    params = jax.tree.map(jnp.asarray,
                          random_vars(jm, seed, *gpt_inputs().values())["params"])
    tm = tgpt.GPTProsody(dim=dim, **SMALL, device="cpu")
    tm.load_state_dict(gpt_prosody_from_jax(params), strict=True)
    return jm, params, tm


@pytest.fixture(scope="module")
def gpt64():
    return gpt_pair(64)


def _t(batch):
    return [torch.from_numpy(v) for v in batch.values()]


def _close(got, want, scale=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=scale * np.abs(want).max())


@pytest.mark.parametrize("dim", [64, 48])
def test_gpt_forward_matches_jax(gpt64, dim):
    jm, params, tm = gpt64 if dim == 64 else gpt_pair(dim)
    batch = gpt_inputs()
    want = jax.jit(jm.apply)({"params": params}, *batch.values())
    with torch.no_grad():
        got = tm(*_t(batch))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    _close(got["logits"], want["logits"])
    np.testing.assert_array_equal(got["targets"].numpy(), np.asarray(want["targets"]))


def test_gpt_gradients_match_jax(gpt64):
    jm, params, _ = gpt64
    tm = tgpt.GPTProsody(dim=64, **SMALL, device="cpu", train=True)
    tm.load_state_dict(gpt_prosody_from_jax(params), strict=True)
    batch = gpt_inputs(seed=3)

    def loss(p):
        return jm.apply({"params": p}, *batch.values())["loss"]

    want = gpt_prosody_from_jax(jax.jit(jax.grad(loss))(params))
    tm(*_t(batch))["loss"].backward()
    for name, p in tm.named_parameters():
        assert rel_l2(p.grad.numpy(), want[name].numpy()) < 1e-4, name


def both_generates(jm, params, tm, top_k, b=2, max_new=16, seed=5):
    batch = gpt_inputs(b=b, seed=7)
    cond, text = batch["cond_mel"], batch["text_ids"]
    jt, jl = jgpt.gpt_generate(params, jm, jnp.asarray(cond), jnp.asarray(text),
                               max_new=max_new, top_k=top_k,
                               rng=jax.random.PRNGKey(seed))
    shape = (b, top_k) if top_k > 0 else (b, jm.n_mel_tokens + 2)
    tt, tl = tgpt.gpt_generate(tm, torch.from_numpy(cond), torch.from_numpy(text),
                               max_new=max_new, top_k=top_k,
                               noise=FedNoise(jax_noise(seed, max_new, shape)))
    return np.asarray(jt), np.asarray(jl), tt.numpy(), tl.numpy()


@pytest.mark.parametrize("top_k", [50, 0])
def test_gpt_generate_matches_jax(gpt64, top_k):
    jm, params, tm = gpt64
    jt, jl, tt, tl = both_generates(jm, params, tm, top_k)
    assert tt.shape == (2, 16)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tl, jl)


def test_gpt_generate_stops_as_jax():
    jm, params, _ = gpt_pair(64, seed=2)
    params = jax.tree.map(np.asarray, params)
    params["mel_head"]["bias"] = params["mel_head"]["bias"].copy()
    params["mel_head"]["bias"][jm.stop_mel] += 8.0   # the stop token is likely
    params = jax.tree.map(jnp.asarray, params)
    tm = tgpt.GPTProsody(dim=64, **SMALL, device="cpu")
    tm.load_state_dict(gpt_prosody_from_jax(params), strict=True)
    jt, jl, tt, tl = both_generates(jm, params, tm, top_k=0, seed=8)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tl, jl)
    assert (tl < 16).all() and (tl > 0).any()
    for row, n in zip(tt, tl):
        assert (row[n:] == jm.stop_mel).all()


def test_gpt_cached_generate_equals_recompute(gpt64):
    _, _, tm = gpt64
    batch = gpt_inputs(b=1, seed=9)
    cond, text = torch.from_numpy(batch["cond_mel"]), torch.from_numpy(batch["text_ids"])
    tokens, _ = tgpt.gpt_generate(tm, cond, text, max_new=10, top_k=1)
    mel_in = torch.full((1, 1), tm.start_mel, dtype=torch.long)
    for step in range(10):
        with torch.no_grad():
            nxt = int(tm.mel_logits(cond, text, mel_in)[0, -1].argmax())
        assert int(tokens[0, step]) == nxt, step
        mel_in = torch.cat([mel_in, torch.tensor([[nxt]])], dim=1)


# ---------- DiscreteVAE ----------


DVAE = dict(channels=32, codebook_size=64, codebook_dim=16)


@pytest.fixture(scope="module")
def dvae():
    jm = jgpt.DiscreteVAE(**DVAE)
    mel = np.random.default_rng(11).standard_normal((2, 40, 80)).astype(np.float32)
    params = random_vars(jm, 12, mel)["params"]
    rng = np.random.default_rng(13)
    embed = (0.5 * rng.standard_normal((64, 16))).astype(np.float32)
    size = rng.uniform(0.5, 3.0, 64).astype(np.float32)
    vq = {"codebook": {"embed": embed, "cluster_size": size,
                       "embed_avg": (1.1 * embed * size[:, None]).astype(np.float32),
                       "inited": np.array(True)}}
    variables = {"params": params, "vq": vq}
    tm = tgpt.DiscreteVAE(**DVAE, device="cpu", train=True)
    tm.load_state_dict(dvae_from_jax(variables), strict=True)
    return jm, variables, tm, mel


def test_dvae_encode_decode_match_jax(dvae):
    jm, variables, tm, mel = dvae
    codes = np.array(jm.apply(variables, mel, method=jgpt.DiscreteVAE.encode))
    got = tm.encode(torch.from_numpy(mel))
    assert got.shape == codes.shape == (2, 10)
    np.testing.assert_array_equal(got.numpy(), codes)
    assert len(np.unique(codes)) > 4
    want = jm.apply(variables, codes, method=jgpt.DiscreteVAE.decode)
    with torch.no_grad():
        _close(tm.decode(torch.from_numpy(codes)), want)


def test_dvae_training_forward_and_ema_match_jax(dvae):
    jm, variables, tm, mel = dvae
    want, new_vars = jm.apply(variables, mel, train=True,
                              rng=jax.random.PRNGKey(0), mutable=["vq"])
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    got = tm(torch.from_numpy(mel), train=True)
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
    _close(got["recon"], want["recon"])
    for k in ("commit", "loss"):
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-5)
    sd = tm.state_dict()
    for name, v in new_vars["vq"]["codebook"].items():
        if name == "inited":
            continue
        _close(sd[f"codebook.{name}"], v)
        assert not torch.equal(sd[f"codebook.{name}"], before[f"codebook.{name}"])
    tm.load_state_dict(before)
