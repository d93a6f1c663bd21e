"""The data-parallel vocoder step of the port at world 2 (two gloo ranks
on the CPU) against the JAX step on a 2-device `data` mesh at the same
global batch.

Configuration, weights, batch and tolerances as tests/test_torch_train_step.py
(the small HierVocoder and MPD; rows of 16 and 13 frames, one to each
rank, so the KL's mask sums differ between the ranks). The ranks are fed
the JAX step's global draws (window starts, z_q's normal) and keep their
rows. Held: the metrics within 1e-4 relative, the reduced gradients within
1e-3 relative L2 per tensor (tensors under 1e-6 of the largest norm left
out, as there), and both ranks' states bitwise equal."""
import numpy as np
import optax

import jax
import jax.numpy as jnp

from megatts2_hierspeechpp_torch.convert import mpd_from_jax, vocoder_from_jax
from megatts2_hierspeechpp_torch.parallel.dryrun import spawn
from megatts2_hierspeechpp_tpu.models.discriminators import (
    MultiPeriodDiscriminator as JaxMPD,
)
from megatts2_hierspeechpp_tpu.train import vocoder as jvt
from megatts2_hierspeechpp_tpu.train.optim import adamw
from tests import torch_dp_ranks as ranks
from tests.test_torch_dp_s2 import check_ranks, mesh_step, t
from tests.test_torch_train_modules import (
    MPD_SMALL,
    SMALL,
    jax_vocoder_params,
    random_tree,
)
from tests.test_torch_train_step import _check_grads, recorder, step_batch

SEG = 8


def test_vocoder_step_world2_matches_jax_mesh(tmp_path):
    jm, params_g = jax_vocoder_params(seed=31)
    jd = JaxMPD(**MPD_SMALL)
    y = np.zeros((1, 2560, 1), np.float32)
    params_d = random_tree(jd.init, 32, y, y)
    batch = step_batch()
    assert tuple(batch["lengths"]) == (16, 13)
    grads_g, grads_d = [], []
    tx_g = optax.chain(recorder(grads_g), adamw(1e-4, steps_per_epoch=10))
    tx_d = optax.chain(recorder(grads_d), adamw(1e-4, steps_per_epoch=10))
    state = jvt.VocTrainState(step=jnp.zeros((), jnp.int32),
                              params_g=params_g, opt_g=tx_g.init(params_g),
                              params_d=params_d, opt_d=tx_d.init(params_d))
    key = jax.random.PRNGKey(7)
    _, want = mesh_step(jvt.make_train_step(jm, jd, tx_g, tx_d,
                                            segment_frames=SEG),
                        state, batch, key)
    rngs = jax.random.split(key, 5)
    starts = np.array(jvt.rand_slice_indices(rngs[3], jnp.asarray(batch["lengths"]),
                                             SEG)).astype(np.int64)
    noise = np.array(jax.random.normal(rngs[0], (2, 16, 192), jnp.float32))

    results = spawn(ranks.vocoder_rank, 2, (
        SMALL, vocoder_from_jax(params_g), MPD_SMALL, mpd_from_jax(params_d),
        batch, starts, noise), store_dir=str(tmp_path))
    check_ranks(results)
    got = results[0]
    assert got["metrics"].keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got["metrics"][k], float(w), rtol=1e-4,
                                   err_msg=k)
    _check_grads(t(got["grads"]["g"]), vocoder_from_jax(grads_g[-1]))
    _check_grads(t(got["grads"]["d"]), mpd_from_jax(grads_d[-1]))
