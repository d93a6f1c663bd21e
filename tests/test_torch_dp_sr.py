"""The data-parallel SpeechSR step of the port at world 2 (two gloo ranks
on the CPU) against the JAX step on a 2-device `data` mesh at the same
global batch of 2 rows, one to each rank.

Configuration, weights, batch and tolerances as tests/test_torch_sr_train.py
(the 48 kHz head at CH 16, one-resolution MPD): the metrics within 1e-4
relative, the reduced gradients and updated parameters within 1e-3
relative L2 per tensor, and both ranks' states bitwise equal."""
import numpy as np
import optax

import jax
import jax.numpy as jnp

from megatts2_hierspeechpp_torch.convert import mpd_from_jax, speechsr_from_jax
from megatts2_hierspeechpp_torch.parallel.dryrun import spawn
from megatts2_hierspeechpp_tpu.models.discriminators import (
    MultiPeriodDiscriminator as JaxMPD,
)
from megatts2_hierspeechpp_tpu.train import speechsr as jsrt
from megatts2_hierspeechpp_tpu.train.optim import adamw
from tests import torch_dp_ranks as ranks
from tests.test_torch_dp_s2 import check_ranks, mesh_step, t
from tests.test_torch_sr_train import CH, MEL, MPD_SR, RATES, SEG_IN, sr_batch, sr_pair
from tests.test_torch_train_modules import random_tree
from tests.test_torch_train_step import _check_grads, _rel_l2, recorder


def test_sr_step_world2_matches_jax_mesh(tmp_path):
    out_sr = 48000
    jm, params_g, _ = sr_pair(out_sr)
    jd = JaxMPD(**MPD_SR)
    y = np.zeros((1, SEG_IN * 3, 1), np.float32)
    params_d = random_tree(jd.init, 42, y, y)
    batch = sr_batch(out_sr)
    grads_g, grads_d = [], []
    tx_g = optax.chain(recorder(grads_g), adamw(1e-4, steps_per_epoch=10))
    tx_d = optax.chain(recorder(grads_d), adamw(1e-4, steps_per_epoch=10))
    state = jsrt.SRTrainState(step=jnp.zeros((), jnp.int32),
                              params_g=params_g, opt_g=tx_g.init(params_g),
                              params_d=params_d, opt_d=tx_d.init(params_d))
    new_state, want = mesh_step(jsrt.make_train_step(jm, jd, tx_g, tx_d,
                                                     sr_out=out_sr, **MEL),
                                state, batch, jax.random.PRNGKey(0))

    results = spawn(ranks.sr_rank, 2, (
        (CH,) + RATES[out_sr], speechsr_from_jax(params_g), MPD_SR,
        mpd_from_jax(params_d), batch, dict(sr_out=out_sr, **MEL)),
        store_dir=str(tmp_path))
    check_ranks(results)
    got = results[0]
    assert got["metrics"].keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got["metrics"][k], float(w), rtol=1e-4,
                                   err_msg=k)
    _check_grads(t(got["grads"]["g"]), speechsr_from_jax(grads_g[-1]))
    _check_grads(t(got["grads"]["d"]), mpd_from_jax(grads_d[-1]))
    for prefix, conv, tree in (("gen.", speechsr_from_jax, new_state.params_g),
                               ("disc.", mpd_from_jax, new_state.params_d)):
        for k, w in conv(tree).items():
            assert _rel_l2(got["state"][prefix + k], w.numpy()) <= 1e-3, k
