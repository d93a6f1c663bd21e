"""The port's Text2Semantic (ar/t2s.py) against the JAX Text2Semantic on the
CPU: the training forward on ragged lengths, its gradients, one forward
with dropout fed the JAX masks, and t2s_decode fed the JAX Gumbel noise
(greedy, top-k, top-p, the full vocabulary, the repetition penalty, the
temperature, B = 2, EOS before max_new); the KV-cached decode against a
full-prefix recompute; the weight carry-over both ways.

Small configuration: 2 layers, width 64, 4 heads, vocab 101 (EOS 100),
phoneme vocab 50, BERT width 1024; seeded port weights (LayerNorms near 1,
biases nonzero) carried to JAX through the JAX package's own convert_t2s.
Tolerances: loss 1e-5 relative, acc exact, logits 1e-5 x max|logits|,
gradients 1e-4 relative L2, decode tokens and lengths exact."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megatts2_hierspeechpp_torch.ar import t2s as tt2s
from megatts2_hierspeechpp_torch.convert import t2s_from_jax
from megatts2_hierspeechpp_torch.nn.decode import FedNoise
from megatts2_hierspeechpp_torch.nn.basic import dropout_masks
from megatts2_hierspeechpp_tpu.ar import t2s as jt2s
from megatts2_hierspeechpp_tpu.models.convert import convert_t2s
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_s2_modules import mask_source, with_masks

SMALL = dict(hidden_dim=64, embedding_dim=64, n_heads=4, n_layers=2,
             vocab_size=101, phoneme_vocab_size=50, top_k_acc=3)
EOS = 100


def perturb(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """LayerNorm scales 1 + N(0, 0.1^2), biases and LayerNorm shifts
    N(0, 0.05^2), position alphas 1 + N(0, 0.1^2)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            n = torch.randn(p.shape, generator=gen)
            if name.endswith("alpha") or (".norm" in name and name.endswith("weight")):
                p.copy_(1.0 + 0.1 * n)
            elif name.endswith("bias"):
                p.copy_(0.05 * n)
    return model


def port_model(p_dropout=0.0, seed=3, train=False):
    return perturb(tt2s.Text2Semantic(**SMALL, p_dropout=p_dropout, seed=seed,
                                      device="cpu", train=train), seed)


def as_jax(model) -> dict:
    return convert_t2s(model.state_dict(), n_layers=SMALL["n_layers"])


@pytest.fixture(scope="module")
def pair():
    tm = port_model()
    return jt2s.Text2Semantic(**SMALL, p_dropout=0.0), as_jax(tm), tm


def train_batch(seed=0):
    rng = np.random.default_rng(seed)
    return dict(x_ids=rng.integers(0, 50, (2, 7)).astype(np.int32),
                x_lens=np.array([7, 5], np.int32),
                y_ids=rng.integers(0, 100, (2, 9)).astype(np.int32),
                y_lens=np.array([9, 6], np.int32),
                bert_feature=rng.standard_normal((2, 7, 1024)).astype(np.float32))


KEYS = ("x_ids", "x_lens", "y_ids", "y_lens", "bert_feature")


def torch_args(batch):
    return [torch.from_numpy(batch[k]) for k in KEYS]


def test_weights_round_trip(pair):
    _, params, tm = pair
    sd = t2s_from_jax(params)
    own = tm.state_dict()
    assert sd.keys() == own.keys()
    for k, v in own.items():
        assert torch.equal(sd[k], v), k


def test_training_forward_matches_jax(pair):
    jm, params, tm = pair
    batch = train_batch()
    want = jax.jit(jm.apply)({"params": params}, *(batch[k] for k in KEYS))
    with torch.no_grad():
        got = tm(*torch_args(batch))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    assert float(got["acc"]) == float(want["acc"])
    wl = np.asarray(want["logits"])
    np.testing.assert_allclose(got["logits"].numpy(), wl, rtol=0,
                               atol=1e-5 * np.abs(wl).max())
    np.testing.assert_array_equal(got["targets"].numpy(), np.asarray(want["targets"]))


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_gradients_match_jax(pair):
    jm, params, _ = pair
    tm = port_model(train=True)
    batch = train_batch(1)

    def loss(p):
        return jm.apply({"params": p}, *(batch[k] for k in KEYS))["loss"]

    want = t2s_from_jax(jax.jit(jax.grad(loss))(params))
    tm(*torch_args(batch))["loss"].backward()
    for name, p in tm.named_parameters():
        assert rel_l2(p.grad.numpy(), want[name].numpy()) < 1e-4, name


def test_dropout_forward_matches_jax_masks():
    tm = port_model(p_dropout=0.1, train=True)
    jm = jt2s.Text2Semantic(**SMALL, p_dropout=0.1)
    params = as_jax(tm)
    batch = train_batch(2)

    def fwd(p):
        return jm.apply({"params": p}, *(batch[k] for k in KEYS),
                        deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(5)})

    want, masks = with_masks(fwd)(params)
    assert len(masks) == 4 * SMALL["n_layers"]
    with dropout_masks(mask_source(masks)) as src, torch.no_grad():
        got = tm(*torch_args(batch))
    assert not src.masks
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    wl = np.asarray(want["logits"])
    np.testing.assert_allclose(got["logits"].numpy(), wl, rtol=0,
                               atol=1e-5 * np.abs(wl).max())


# ---------- decode ----------


def test_jax_categorical_is_gumbel_argmax():
    """What the port's sampler rests on: categorical(k, l) equals
    argmax(gumbel(k, l.shape) + l), for the top-k and the full-vocab
    shapes of the decode."""
    rng = np.random.default_rng(9)
    for i, shape in enumerate([(1, 3), (2, 3), (1, 101), (2, 101)]):
        logits = jnp.asarray(rng.standard_normal(shape) * 3, jnp.float32)
        key = jax.random.PRNGKey(100 + i)
        want = jax.random.categorical(key, logits, axis=-1)
        got = jnp.argmax(jax.random.gumbel(key, logits.shape) + logits, axis=-1)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def jax_noise(seed: int, steps: int, shape):
    """The Gumbel draws of the JAX decode's split chain from PRNGKey(seed)."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        out.append(np.asarray(jax.random.gumbel(sub, shape)))
    return out


def decode_inputs(b=1, x_len=6, p_len=4, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 50, (1, x_len)).astype(np.int32)
    bert = rng.standard_normal((1, x_len, 1024)).astype(np.float32)
    prompts = rng.integers(0, 100, (b, p_len)).astype(np.int32)
    return np.repeat(x, b, 0), np.repeat(bert, b, 0), prompts


CASES = {
    "greedy": dict(top_k=1),
    "top_k 3": dict(top_k=3),
    "top_k 3, top_p 0.8": dict(top_k=3, top_p=0.8),
    "full vocab": dict(top_k=0),
    "repetition_penalty 1.3": dict(top_k=3, repetition_penalty=1.3),
    "temperature 0.7": dict(top_k=3, temperature=0.7),
    "B=2": dict(top_k=3, b=2),
}


def both_decodes(jm, params, tm, max_new=24, b=1, seed=7, **kw):
    x, bert, prompts = decode_inputs(b=b)
    jt, jl = jt2s.t2s_decode(params, jm, jnp.asarray(x), jnp.asarray(bert),
                             jnp.asarray(prompts), max_new=max_new,
                             rng=jax.random.PRNGKey(seed), **kw)
    k = kw.get("top_k", 3)
    shape = (b, k) if k else (b, SMALL["vocab_size"])
    tt, tl = tt2s.t2s_decode(tm, torch.from_numpy(x), torch.from_numpy(bert),
                             torch.from_numpy(prompts), max_new=max_new,
                             noise=FedNoise(jax_noise(seed, max_new, shape)),
                             **kw)
    return np.asarray(jt), np.asarray(jl), tt.numpy(), tl.numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_decode_matches_jax(pair, case):
    jm, params, tm = pair
    kw = dict(CASES[case])
    jt, jl, tt, tl = both_decodes(jm, params, tm, **kw)
    assert tt.shape == jt.shape == (kw.get("b", 1), 24)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tl, jl)


@pytest.fixture(scope="module")
def eos_pair():
    """A model whose EOS logit is raised, so sampled rows stop early."""
    tm = port_model(seed=4)
    with torch.no_grad():
        tm.ar_predict_layer.weight[EOS] *= 6.0
    return jt2s.Text2Semantic(**SMALL, p_dropout=0.0), as_jax(tm), tm


def test_decode_stops_at_eos_as_jax(eos_pair):
    jm, params, tm = eos_pair
    jt, jl, tt, tl = both_decodes(jm, params, tm, max_new=24, b=2, top_k=0,
                                  seed=11)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tl, jl)
    assert (tl < 24).all() and (tl > 0).any()
    for row, n in zip(tt, tl):
        assert (row[n:] == EOS).all() and (row[:n] != EOS).all()


def test_cached_decode_equals_full_recompute(pair):
    """Greedy: every cached step's token is the argmax of a full-prefix
    re-run on the tokens so far (the pattern of tests/test_ar.py)."""
    _, _, tm = pair
    x, bert, prompts = decode_inputs(x_len=5, p_len=3, seed=2)
    tokens, _ = tt2s.t2s_decode(tm, torch.from_numpy(x), torch.from_numpy(bert),
                                torch.from_numpy(prompts), max_new=12, top_k=1)
    y = torch.from_numpy(prompts).long()
    for step in range(12):
        with torch.no_grad():
            logits = tm.prefix_logits(torch.from_numpy(x), torch.from_numpy(bert), y)
        nxt = int(logits[0, -1].argmax())
        assert int(tokens[0, step]) == nxt, step
        if nxt == EOS:
            break
        y = torch.cat([y, torch.tensor([[nxt]])], dim=1)
