"""The data-parallel denoiser step of the port at world 2 (two gloo ranks
on the CPU) against the JAX step on a 2-device `data` mesh at the same
global batch of 2 clips, one to each rank.

MPNet's training forward is not row-separable: its attention runs over
axis 0, batch x freq in the time conformer and batch x frames in the
frequency conformer (the reference's batch_first=False quirk), and its
BatchNorm takes statistics over the batch. Under GSPMD the JAX step does
both over the global batch; the port gathers every rank's keys and values
and reduces BatchNorm's sums across the ranks. The ranks run with remat
and query chunks of 8 rows, so the gathers also run inside the
checkpointed recompute of the backward.

Configuration, weights, batch and tolerances as tests/test_torch_denoiser_train.py
(MPNet(dense_channel=8, num_tsblocks=2), one STFT fed to both sides): the
metrics within 1e-4 relative, the reduced gradients and updated entries
within 1e-3 relative L2 over the entries above 1e-6 of the largest
gradient, every updated entry within 2 x lr, BatchNorm's running
statistics within 1e-5 relative L2, both ranks' states bitwise equal. A
rank-local attention (no gather) misses the JAX step."""
import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp

from megatts2_hierspeechpp_torch.convert import denoiser_from_jax
from megatts2_hierspeechpp_tpu.models.denoiser import MPNet as JaxMPNet
from megatts2_hierspeechpp_tpu.train import denoiser as jdnt
from megatts2_hierspeechpp_tpu.train.optim import adamw
from megatts2_hierspeechpp_torch.parallel.dryrun import spawn
from tests import torch_dp_ranks as ranks
from tests.test_torch_denoiser_train import (
    CFG,
    SMALL,
    dn_batch,
    jax_spectra,
    jax_variables,
)
from tests.test_torch_dp_s2 import check_ranks, mesh_step
from tests.test_torch_train_step import _rel_l2, recorder

LR = 5e-4


@pytest.fixture(scope="module")
def jax_step():
    variables = jax_variables(seed=53)
    batch = dn_batch(seed=54)
    grads = []
    tx = optax.chain(recorder(grads), adamw(LR, max_grad_norm=5.0,
                                            steps_per_epoch=10))
    state = jdnt.DenoiserTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt=tx.init(variables["params"]))
    new_state, want = mesh_step(jdnt.make_train_step(JaxMPNet(**SMALL), tx),
                                state, batch, jax.random.PRNGKey(0))
    return variables, batch, new_state, want, grads[-1]


def run_ranks(jax_step, tmp_path, local_attention=False, **mp_kw):
    variables, batch, *_ = jax_step
    return spawn(ranks.denoiser_rank, 2, (
        dict(SMALL, **mp_kw), denoiser_from_jax(variables),
        jax_spectra(batch), batch["clean"], CFG, local_attention),
        store_dir=str(tmp_path))


def test_denoiser_step_world2_matches_jax_mesh(jax_step, tmp_path):
    variables, _, new_state, want, jgrads = jax_step
    results = run_ranks(jax_step, tmp_path, remat=True, attn_chunk=8)
    check_ranks(results)
    got = results[0]
    assert got["metrics"].keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got["metrics"][k], float(w), rtol=1e-4,
                                   err_msg=k)
    want_g = denoiser_from_jax({"params": jgrads,
                                "batch_stats": variables["batch_stats"]})
    names = list(got["grads"]["g"])
    assert set(names) == {k for k in want_g if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))}
    floor = 1e-6 * max(float(want_g[k].abs().max()) for k in names)
    want_sd = denoiser_from_jax({"params": new_state.params,
                                 "batch_stats": new_state.batch_stats})
    for k in names:
        g, w = got["grads"]["g"][k], want_g[k].numpy()
        live = np.abs(w) > floor
        assert np.abs(g[~live]).max(initial=0) <= floor, k
        if live.any():
            assert _rel_l2(g[live], w[live]) <= 1e-3, k
            assert _rel_l2(got["state"][k][live],
                           want_sd[k].numpy()[live]) <= 1e-3, k
        assert np.abs(got["state"][k] - want_sd[k].numpy()).max() <= 2 * LR * 1.001, k
    stats = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 8
    for k in stats:   # the global batch's statistics, unbiased on its count
        assert _rel_l2(got["state"][k], want_sd[k].numpy()) <= 1e-5, k


def test_rank_local_attention_misses_the_jax_step(jax_step, tmp_path):
    _, _, _, want, _ = jax_step
    got = run_ranks(jax_step, tmp_path, local_attention=True)[0]
    errs = {k: abs(got["metrics"][k] - float(w)) / abs(float(w))
            for k, w in want.items()}
    # 10 x the parity test's tolerance
    assert max(errs.values()) > 1e-3, errs
