"""Tensor-parallel ProsodyLM and Text2Semantic (parallel/tp.py) at world 2,
two gloo ranks on the CPU, against the JAX models with `shard_params` on a
(1, 2) data x model mesh and against the port's one-card decodes.

ProsodyLM at test_torch_plm.SMALL (d 64, 4 heads, 2 layers): the
teacher-forced loss within 1e-5 relative of the JAX sharded apply; greedy
codes equal the JAX sharded decode and the one-card `decode`; top-k 5
codes (T 0.8, one seed) equal the one-card `decode`'s draw, and each lies
within the top 5 of the JAX sharded teacher-forced logits at its step (1e-4
x max|logit| of slack). Text2Semantic at test_torch_ar.SMALL (4 heads):
`t2s_decode` on the rank's shard with the JAX decode's Gumbel draws
(`FedNoise`) gives the JAX sharded decode's tokens and lengths, top-k 3
and the full vocabulary. Every rank draws the same tokens. Rank 0's
packed in_proj holds heads 0..H/2 of each of q, k and v."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megatts2_hierspeechpp_torch.convert import plm_from_jax
from megatts2_hierspeechpp_torch.models import plm as tplm
from megatts2_hierspeechpp_torch.parallel.dryrun import spawn
from megatts2_hierspeechpp_torch.parallel.tp import shard_module
from megatts2_hierspeechpp_tpu.ar import t2s as jt2s
from megatts2_hierspeechpp_tpu.models import plm as jplm
from megatts2_hierspeechpp_tpu.parallel.mesh import make_mesh
from megatts2_hierspeechpp_tpu.parallel.tp import shard_params
from tests import torch_dp_ranks as ranks
from tests.test_torch_ar import SMALL as T2S_SMALL
from tests.test_torch_ar import as_jax, decode_inputs, jax_noise, port_model
from tests.test_torch_plm import SMALL, _tc, plm_params

T, MAX_NEW = 20, 16


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    jm = jplm.ProsodyLM(**SMALL, p_dropout=0.0)
    params = plm_params(jm, 31)
    tc = _tc(T, 5, b=2)
    codes = np.random.default_rng(6).integers(0, 1024, (2, T)).astype(np.int32)
    lens = np.array([T, T - 6], np.int32)
    tm = port_model(seed=3)
    t2s_params = as_jax(tm)
    x, bert, prompts = decode_inputs(b=1)
    cases = {"top_k 3": 3, "full vocab": 0}
    mesh = make_mesh(n_data=1, n_model=2)
    want = {"params": params}
    with mesh:
        sharded = shard_params(mesh, params)
        want["loss"] = float(jax.jit(lambda p: jm.apply(
            {"params": p}, tc, codes, lens)["loss"])(sharded))
        want["greedy"] = np.asarray(jplm.decode(sharded, jnp.asarray(tc),
                                                n_layers=2, n_heads=4))
        fwd = jax.jit(lambda p, c: jm.apply({"params": p}, tc, c,
                                            np.full((2,), T, np.int32))["logits"])
        t2s_sharded = shard_params(mesh, t2s_params)
        for case, k in cases.items():
            want[case] = tuple(np.asarray(a) for a in jt2s.t2s_decode(
                t2s_sharded, jt2s.Text2Semantic(**T2S_SMALL, p_dropout=0.0),
                jnp.asarray(x), jnp.asarray(bert), jnp.asarray(prompts),
                max_new=MAX_NEW, rng=jax.random.PRNGKey(7), top_k=k))
    store = str(tmp_path_factory.mktemp("tp"))
    got = {}
    for case, k in cases.items():
        shape = (1, k) if k else (1, T2S_SMALL["vocab_size"])
        got[case] = spawn(ranks.tp_rank, 2, (
            SMALL, plm_from_jax(params), tc, codes, lens,
            dict(T2S_SMALL, seed=3), tm.state_dict(), (x, bert, prompts),
            jax_noise(7, MAX_NEW, shape), dict(max_new=MAX_NEW, top_k=k)),
            store_dir=store)
    return want, got, (sharded, fwd), tm


def test_ranks_agree(tp_run):
    _, got, _, _ = tp_run
    for results in got.values():
        a, b = results
        for k, v in a.items():
            if k != "in_proj_weight":
                np.testing.assert_array_equal(v, b[k], err_msg=k)


def test_plm_loss_and_greedy_match_jax_sharded(tp_run):
    want, got, _, _ = tp_run
    r = got["top_k 3"][0]
    np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_array_equal(r["greedy"], want["greedy"])
    one = tplm.ProsodyLM(**SMALL, device="cpu")
    one.load_state_dict(plm_from_jax(want["params"]), strict=True)
    np.testing.assert_array_equal(
        r["greedy"], tplm.decode(one, torch.from_numpy(_tc(T, 5, b=2))).numpy())


def test_plm_top_k_matches_one_card_and_jax_logits(tp_run):
    _, got, (sharded, fwd), _ = tp_run
    r = got["top_k 3"][0]
    np.testing.assert_array_equal(r["topk"], r["topk_one"])
    logits = np.asarray(fwd(sharded, r["topk"]))
    kth = np.sort(logits, -1)[..., -5]
    chosen = np.take_along_axis(logits, r["topk"][..., None].astype(np.int64), -1)[..., 0]
    assert (chosen >= kth - 1e-4 * np.abs(logits).max()).all()


@pytest.mark.parametrize("case", ["top_k 3", "full vocab"])
def test_t2s_decode_matches_jax_sharded(tp_run, case):
    want, got, _, _ = tp_run
    r = got[case][0]
    np.testing.assert_array_equal(r["t2s_tokens"], want[case][0])
    np.testing.assert_array_equal(r["t2s_lengths"], want[case][1])


def test_t2s_shard_cuts_q_k_v_by_heads(tp_run):
    _, got, _, tm = tp_run
    w = tm.h.layers[0].self_attn.in_proj_weight.detach().numpy()
    d = w.shape[1]
    half = d // 2
    for rank, r in enumerate(got["top_k 3"]):
        rows = np.concatenate([np.arange(j * d + rank * half, j * d + (rank + 1) * half)
                               for j in range(3)])
        np.testing.assert_array_equal(r["in_proj_weight"], w[rows])
    # a contiguous cut of the packed axis would hold all of q and half of k
    assert not np.array_equal(got["top_k 3"][0]["in_proj_weight"], w[:3 * half])
    shard = shard_module(tm, 1, 2)
    assert shard.h.layers[0].self_attn.n_heads == T2S_SMALL["n_heads"] // 2
    assert tm.h.layers[0].self_attn.n_heads == T2S_SMALL["n_heads"]
