"""The data-parallel AR step of the port at world 2 (two gloo ranks on the
CPU) against the JAX step on a 2-device `data` mesh at the same global
batches: four micro-steps at grad_accum 2, so two updates.

The AR loss is a CE *sum* over every position of the global batch, so the
global gradient is the sum of the ranks' gradients, not their mean; each
rank accumulates its own and the buffer is summed over the ranks when an
update is applied. The micro-batches' two rows (x 8 / 6 phones, y 16 / 11
tokens) go one to each rank. Configuration and tolerances as
tests/test_torch_ar_train.py: the loss (summed) and the accuracy (over the
global count) within 1e-4 relative at each micro-step, the parameters and
ScaledAdam's moments after the last update within 1e-4 relative L2 (the
key third of in_proj_bias, whose true gradient is zero, left out of the
parameters), both ranks' parameters bitwise equal."""
import numpy as np

import jax
import jax.numpy as jnp

from megatts2_hierspeechpp_torch.convert import t2s_from_jax
from megatts2_hierspeechpp_torch.parallel.dryrun import spawn
from megatts2_hierspeechpp_tpu.ar import scaled_adam as jsa
from megatts2_hierspeechpp_tpu.ar import t2s as jt2s
from megatts2_hierspeechpp_tpu.ar import trainer as jtrainer
from megatts2_hierspeechpp_tpu.parallel.mesh import make_mesh, shard_batch
from tests import torch_dp_ranks as ranks
from tests.test_torch_ar import SMALL, as_jax, port_model, rel_l2
from tests.test_torch_ar_train import SCHED, micro_batches, without_key_bias


def test_ar_accumulated_steps_world2_match_jax_mesh(tmp_path):
    tm = port_model(train=True)
    params = as_jax(tm)
    jm = jt2s.Text2Semantic(**SMALL, p_dropout=0.0)
    tx = jsa.scaled_adam(learning_rate=jsa.warmup_cosine_schedule(*SCHED))
    state = jtrainer.ARTrainState(
        step=jnp.zeros((), jnp.int32), params=params, opt=tx.init(params),
        accum=jax.tree.map(jnp.zeros_like, params),
        accum_count=jnp.zeros((), jnp.int32))
    batches = micro_batches(n=4, seed=21)
    assert all(tuple(b["y_lens"]) == (16, 11) for b in batches)
    mesh = make_mesh(n_data=2)
    want = []
    with mesh:
        step = jax.jit(jtrainer.make_train_step(jm, tx, grad_accum=2))
        for i, b in enumerate(batches):
            state, m = step(state, shard_batch(mesh, b), jax.random.PRNGKey(i))
            want.append({k: float(v) for k, v in m.items()})

    results = spawn(ranks.ar_rank, 2, (
        dict(SMALL, p_dropout=0.0, seed=3), tm.state_dict(), SCHED, batches, 2),
        store_dir=str(tmp_path))
    a, b = results
    assert a["metrics"] == b["metrics"] and a["accum_count"] == 0
    for k, v in a["state"].items():
        np.testing.assert_array_equal(v, b["state"][k], err_msg=k)
    for i, (g, w) in enumerate(zip(a["metrics"], want)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4,
                                       err_msg=f"{k} at micro-step {i + 1}")
    trees = {"state": t2s_from_jax(state.params), "mu": t2s_from_jax(state.opt.mu),
             "nu": t2s_from_jax(state.opt.nu)}
    for tree, w in trees.items():
        for n, g in a[tree].items():
            wn = w[n].numpy()
            if tree == "state" and n.endswith("in_proj_bias"):
                g, wn = without_key_bias(g, wn)
            assert rel_l2(g, wn) < 1e-4, (tree, n)
