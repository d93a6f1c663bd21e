"""One whole vocoder train step of the port against the JAX package's
make_train_step on the CPU.

Small configuration (as tests/test_train_s1_vocoder.py; see
test_torch_train_modules.py): B = 2 utterances of 16 and 13 frames,
segment_frames 8, AdamW(1e-4) on both sides. Both steps start from the same
weights (a seeded JAX tree carried over by convert.*_from_jax), and the
port is fed the JAX step's own draws: the window starts from
rand_slice_indices(split(rng, 5)[3], ...) and z_q's normal from
split(rng, 5)[0]. The JAX step's gradients are read where optax receives
them. Tolerances: every metric within 1e-4 relative; G and D gradients
within 1e-3 relative L2 per parameter tensor whose norm is above 1e-6 of
the largest (float32 sums in another order through the step's two
backward passes; the feature-matching L1's signs flip on rounding, which
moves some generator gradients by up to 8e-4 from float64's).

The JAX step is compiled at XLA's lowest backend optimisation level: the
default takes many minutes to compile on a CPU, and the level changes no
arithmetic that the tolerances could see."""
import numpy as np
import optax
import torch

import jax
import jax.numpy as jnp

from megatts2_hierspeechpp_torch.convert import mpd_from_jax, vocoder_from_jax
from megatts2_hierspeechpp_torch.models.discriminators import (
    MultiPeriodDiscriminator as TorchMPD,
)
from megatts2_hierspeechpp_torch.models.vocoder import HierVocoder as TorchVocoder
from megatts2_hierspeechpp_torch.train import vocoder as tvt
from megatts2_hierspeechpp_tpu.models.discriminators import (
    MultiPeriodDiscriminator as JaxMPD,
)
from megatts2_hierspeechpp_tpu.train import vocoder as jvt
from megatts2_hierspeechpp_tpu.train.optim import adamw
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_train_modules import (
    MPD_SMALL,
    SMALL,
    jax_vocoder_params,
    random_tree,
)

B, T, SEG = 2, 16, 8
LENGTHS = (16, 13)


def step_batch(seed=30):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    mask = np.zeros((B, T, 1), f32)
    audio = np.zeros((B, 320 * T), f32)
    f0 = np.zeros((B, 4 * T), f32)
    for i, n in enumerate(LENGTHS):
        mask[i, :n] = 1
        audio[i, :320 * n] = rng.uniform(-0.5, 0.5, 320 * n)
        f0[i, :4 * n] = np.where(rng.uniform(size=4 * n) < 0.7,
                                 rng.uniform(90, 260, 4 * n), 0.0)
    return {"spec": np.abs(rng.standard_normal((B, T, 641))).astype(f32) * mask,
            "audio": audio,
            "mel": rng.standard_normal((B, T, 80)).astype(f32) * mask,
            "w2v": rng.standard_normal((B, T, 1024)).astype(f32) * mask,
            "f0": f0, "mask": mask,
            "lengths": np.asarray(LENGTHS, np.int32)}


def recorder(store: list):
    """An optax stage that passes the gradients on and keeps a numpy copy."""
    def update(updates, state, params=None):
        jax.debug.callback(lambda g: store.append(g), updates)
        return updates, state

    return optax.GradientTransformation(lambda params: optax.EmptyState(),
                                        update)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _check_grads(got: dict, want: dict):
    norms = {k: float(np.linalg.norm(v)) for k, v in want.items()}
    floor = 1e-6 * max(norms.values())
    assert got.keys() == want.keys()
    checked = 0
    for k, w in want.items():
        g = got[k]
        assert g is not None, k
        if norms[k] > floor:
            err = _rel_l2(g.numpy(), w.numpy())
            assert err <= 1e-3, (k, err)
            checked += 1
    assert checked > 0.9 * len(want)


def test_train_step_matches_jax():
    jm, params_g = jax_vocoder_params(seed=31)
    jd = JaxMPD(**MPD_SMALL)
    y = np.zeros((1, 2560, 1), np.float32)
    params_d = random_tree(jd.init, 32, y, y)
    batch = step_batch()
    grads_g, grads_d = [], []
    tx_g = optax.chain(recorder(grads_g), adamw(1e-4, steps_per_epoch=10))
    tx_d = optax.chain(recorder(grads_d), adamw(1e-4, steps_per_epoch=10))
    state = jvt.VocTrainState(step=jnp.zeros((), jnp.int32),
                              params_g=params_g, opt_g=tx_g.init(params_g),
                              params_d=params_d, opt_d=tx_d.init(params_d))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(7)
    step = jax.jit(jvt.make_train_step(jm, jd, tx_g, tx_d, segment_frames=SEG))
    compiled = step.lower(state, jbatch, key).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True})
    _, want = compiled(state, jbatch, key)
    jax.effects_barrier()
    assert len(grads_g) == len(grads_d) == 1
    rngs = jax.random.split(key, 5)
    starts = np.array(jvt.rand_slice_indices(rngs[3], jbatch["lengths"], SEG))
    noise = np.array(jax.random.normal(rngs[0], (B, T, 192), jnp.float32))

    gen = TorchVocoder(**SMALL, device="cpu", train=True)
    gen.load_state_dict(vocoder_from_jax(params_g), strict=True)
    disc = TorchMPD(**MPD_SMALL, device="cpu")
    disc.load_state_dict(mpd_from_jax(params_d), strict=True)
    tstate = tvt.create_state(gen, disc, lr=1e-4, steps_per_epoch=10)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["lengths"] = tbatch["lengths"].long()
    tstate, got = tvt.TrainStep(segment_frames=SEG).with_draws(
        tstate, tbatch, torch.from_numpy(starts).long(), torch.from_numpy(noise))

    assert tstate.step == 1
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-4,
                                   err_msg=k)
    # the converters' layouts are permutations, so they carry gradients too
    _check_grads({k: p.grad for k, p in gen.named_parameters()},
                 vocoder_from_jax(grads_g[0]))
    _check_grads({k: p.grad for k, p in disc.named_parameters()},
                 mpd_from_jax(grads_d[0]))
