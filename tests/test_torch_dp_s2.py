"""Data-parallel s2 and s1 steps of the port at world 2 (two gloo ranks on
the CPU) against the JAX steps on a 2-device `data` mesh at the same global
batch.

The configurations, weights, batches and tolerances are those of
tests/test_torch_s2_step.py and tests/test_torch_s1.py (TTV_SMALL, the
full MRSD, ProsodyLM(n_layers=2)); the global batch's two rows, 16 and 13
frames, go one to each rank, so the ranks hold different valid lengths
and different code histograms (a rank-local mask sum or RVQ EMA step would
differ from JAX's). Each rank is fed the JAX step's global dropout masks
and keeps its rows. Held: the metrics within 1e-4 relative, the reduced
gradients and updated parameters within 1e-3 relative L2 per tensor (the
near-zero tensors as in test_torch_s2_step.check_tensors), the RVQ
codebooks and statistics and the spectral norm's u / v within 1e-5, and
both ranks' states bitwise equal. Then k-means: cli/train_s2.kmeans_init
at world 2 fits on both ranks' pooled features, as one process fits on the
whole batch, and the ranks' codebooks are equal."""
import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax

from megatts2_hierspeechpp_torch.convert import (
    mrsd_from_jax,
    plm_from_jax,
    ttv_from_jax,
)
from megatts2_hierspeechpp_torch.parallel.dryrun import spawn
from megatts2_hierspeechpp_tpu.models import plm as jplm
from megatts2_hierspeechpp_tpu.models.ttv import TTVModel as JaxTTV
from megatts2_hierspeechpp_tpu.parallel.mesh import make_mesh, shard_batch
from megatts2_hierspeechpp_tpu.train import s1 as js1
from megatts2_hierspeechpp_tpu.train import s2 as js2
from megatts2_hierspeechpp_tpu.train.optim import adamw
from tests import torch_dp_ranks as ranks
from tests.test_torch_acoustic import TTV_SMALL, random_ttv_vars
from tests.test_torch_plm import plm_params
from tests.test_torch_s2_modules import (
    EXTRACT_INPUTS,
    FAST,
    fast_jit,
    jax_train_forward,
    mrsd_vars,
    s2_batch,
    with_masks,
)
from tests.test_torch_s2_step import check_tensors, coin_keys
from tests.test_torch_train_step import recorder


def mesh_step(step_fn, state, batch, key):
    """The JAX step on a 2-device data mesh, the batch sharded on axis 0,
    compiled at the lowest optimisation level: (new state, metrics)."""
    mesh = make_mesh(n_data=2)
    with mesh:
        sb = shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
        out = jax.jit(step_fn).lower(state, sb, key).compile(
            compiler_options=FAST)(state, sb, key)
        jax.effects_barrier()
    return out


def t(d):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in d.items()}


def check_ranks(results):
    """Both ranks report the same metrics and hold bitwise the same state."""
    a, b = results
    assert a["metrics"] == b["metrics"]
    assert a["state"].keys() == b["state"].keys()
    for k, v in a["state"].items():
        np.testing.assert_array_equal(v, b["state"][k], err_msg=k)


def test_s2_step_world2_matches_jax_mesh(tmp_path):
    jm = JaxTTV(**TTV_SMALL)
    jvars = random_ttv_vars(jm, 71)
    batch = s2_batch(seed=72)
    assert tuple(batch["mel_lengths"]) == (16, 13)
    jd, dvars = mrsd_vars(73, np.zeros((1, 1024, 16), np.float32))
    grads_g, grads_d = [], []
    tx_g = optax.chain(recorder(grads_g), adamw(1e-4, steps_per_epoch=10))
    tx_d = optax.chain(recorder(grads_d), adamw(1e-4, steps_per_epoch=10))
    state = js2.S2TrainState(
        step=jnp.zeros((), jnp.int32), params_g=jvars["params"], vq=jvars["vq"],
        opt_g=tx_g.init(jvars["params"]), params_d=dvars["params"],
        spectral=dvars["spectral"], opt_d=tx_d.init(dvars["params"]))
    key = coin_keys()[True]
    new, want = mesh_step(js2.make_train_step(jm, jd, tx_g, tx_d, c_mel=1.0,
                                              c_commit=100.0),
                          state, batch, key)
    (_, _), masks = jax_train_forward(jm, jvars, batch, True,
                                      jax.random.split(key, 3)[0], True)

    results = spawn(ranks.s2_rank, 2, (
        TTV_SMALL, ttv_from_jax(jvars), mrsd_from_jax(dvars), batch, True,
        [np.array(m) for m in masks]), store_dir=str(tmp_path))
    check_ranks(results)
    got = results[0]
    assert got["metrics"].keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got["metrics"][k], float(w), rtol=1e-4,
                                   err_msg=k)
    want_g = ttv_from_jax({"params": grads_g[-1], "vq": jvars["vq"]})
    check_tensors(t(got["grads"]["g"]),
                  {k: want_g[k] for k in got["grads"]["g"]}, 1e-3, 1e-6)
    want_d = mrsd_from_jax({"params": grads_d[-1], "spectral": dvars["spectral"]})
    check_tensors(t(got["grads"]["d"]),
                  {k: want_d[k] for k in got["grads"]["d"]}, 1e-3, 1e-6)
    new_g = ttv_from_jax({"params": new.params_g, "vq": new.vq})
    sd = {k[len("ttv."):]: v for k, v in got["state"].items()
          if k.startswith("ttv.")}
    names = list(got["grads"]["g"])
    check_tensors(t({k: sd[k] for k in names}), {k: new_g[k] for k in names},
                  1e-3, step_atol=2e-4)
    quant = [k for k in new_g if k.startswith("quantizer.")]
    assert len(quant) >= 4
    for k in quant:   # the EMA step of the global batch's statistics
        np.testing.assert_allclose(sd[k], new_g[k].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    new_d = mrsd_from_jax({"params": new.params_d, "spectral": new.spectral})
    sd = {k[len("disc."):]: v for k, v in got["state"].items()
          if k.startswith("disc.")}
    for k, v in new_d.items():
        if k not in got["grads"]["d"]:   # u / v
            np.testing.assert_allclose(sd[k], v.numpy(), atol=1e-5, err_msg=k)


def test_s1_step_world2_matches_jax_mesh(tmp_path):
    jttv = JaxTTV(**TTV_SMALL)
    ttv_vars = random_ttv_vars(jttv, 91)
    jm = jplm.ProsodyLM(n_layers=2)
    params = plm_params(jm, 92)
    batch = s2_batch(seed=93)
    grads = []
    tx = optax.chain(recorder(grads), adamw(1e-4, steps_per_epoch=10))
    state = js1.S1TrainState(step=jnp.zeros((), jnp.int32), params_plm=params,
                             opt_plm=tx.init(params), ttv_vars=ttv_vars)
    key = jax.random.PRNGKey(94)
    new, want = mesh_step(js1.make_train_step(jttv, jm, tx), state, batch, key)
    x_frame, lr = jttv.apply(ttv_vars, *(batch[k] for k in EXTRACT_INPUTS),
                             method=JaxTTV.extract_tc_latent_code)
    fn = with_masks(lambda p, a, c, n, k: jm.apply(
        {"params": p}, a, c, n, deterministic=False, rngs={"dropout": k}))
    args = (params, x_frame, lr, batch["mel_lengths"], key)
    _, masks = fast_jit(fn, *args)(*args)

    results = spawn(ranks.s1_rank, 2, (
        TTV_SMALL, ttv_from_jax(ttv_vars), dict(n_layers=2),
        plm_from_jax(params), batch, [np.array(m) for m in masks]),
        store_dir=str(tmp_path))
    check_ranks(results)
    got = results[0]
    assert got["metrics"].keys() == want.keys()
    for k, w in want.items():   # loss per frame, top-10 accuracy: global
        np.testing.assert_allclose(got["metrics"][k], float(w), rtol=1e-4,
                                   err_msg=k)
    want_g = plm_from_jax(grads[-1])
    assert want_g.keys() == got["grads"]["g"].keys()
    check_tensors(t(got["grads"]["g"]), want_g, 1e-3, 1e-6)
    new_p = plm_from_jax(new.params_plm)
    check_tensors(t({k: got["state"][k] for k in new_p}), new_p, 1e-3,
                  step_atol=2e-4)


def test_kmeans_init_fits_every_ranks_features(tmp_path):
    from megatts2_hierspeechpp_torch.cli.train_s2 import kmeans_init
    from megatts2_hierspeechpp_torch.models.ttv import TTVModel

    ttv = TTVModel(**TTV_SMALL, seed=4, device="cpu", train=True)
    sd = {k: v.clone() for k, v in ttv.state_dict().items()}
    batch = s2_batch(seed=72)
    # the rows of the first batch of every rank, in rank order, in one process
    kmeans_init(ttv, batch, seed=5)
    want = {k: v.numpy() for k, v in ttv.quantizer.state_dict().items()}
    got = spawn(ranks.kmeans_rank, 2, (TTV_SMALL, sd, batch), store_dir=str(tmp_path))
    for k, w in want.items():
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
        np.testing.assert_allclose(got[0][k], w, rtol=1e-5, atol=1e-6, err_msg=k)
    # one rank's features alone fit other codebooks
    alone = TTVModel(**TTV_SMALL, seed=4, device="cpu", train=True)
    kmeans_init(alone, {k: v[:1] for k, v in batch.items()}, seed=5)
    assert not np.allclose(alone.quantizer.state_dict()[
        "vq.layers.0._codebook.embed"].numpy(),
        want["vq.layers.0._codebook.embed"])
