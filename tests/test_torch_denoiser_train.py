"""MP-SENet denoiser training in the port (models/denoiser.MPNet(train=True),
train/denoiser.py, train/evalhooks.make_denoiser_eval_fn,
cli/train_denoiser.py) against the JAX package on the CPU.

Small configuration: MPNet(dense_channel=8, num_tsblocks=2), B = 2 clips of
2000 samples (21 STFT frames); seeded random JAX variables with BatchNorm
running statistics away from mean 0 / var 1, carried over by
convert.denoiser_from_jax. The step is fed one STFT, the JAX front end's,
through TrainStep.with_spectra: the first frame's phases are +-pi by the
FFT's rounding (ROADMAP.md section 3), and MPNet reads the phase.

Tolerances: anti_wrapping / phase_losses within 1e-6; the training
forward's magnitude within 2e-4 and its phase within 2e-4 on the circle
(the serving tests' bounds), its BatchNorm running statistics within 1e-5
of their largest; one step's metrics within 1e-4 relative, gradients and
updated parameters within 1e-3 relative L2 per tensor, the statistics
within 1e-5 relative L2. Entries whose gradient is below 1e-6 of the
largest are zero in exact arithmetic (the biases right before an
InstanceNorm or BatchNorm, the attention's key bias): their gradients stay
below that floor on both sides and are left out of the relative L2, and
Adam's first step moves them by +-lr on the sign of the noise, so every
updated entry is held within 2 x lr; remat on against off equal but for float rounding (loss rtol
1e-6, gradients rtol 1e-5, statistics exactly); chunked against dense
attention within JAX's own bounds (tests/test_train_misc.py: loss rtol
1e-6, gradients rtol 5e-3 / atol 5e-6); the eval scalars within 1e-4
relative; batches and the resumed run's losses equal."""
import json
import os
import shutil

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from megatts2_hierspeechpp_torch.cli import train_denoiser as tcli
from megatts2_hierspeechpp_torch.convert import denoiser_from_jax
from megatts2_hierspeechpp_torch.models.denoiser import MPNet as TorchMPNet
from megatts2_hierspeechpp_torch.train import denoiser as tdnt
from megatts2_hierspeechpp_torch.train import evalhooks as tev
from megatts2_hierspeechpp_tpu.cli import train_denoiser as jcli
from megatts2_hierspeechpp_tpu.models.denoiser import MPNet as JaxMPNet
from megatts2_hierspeechpp_tpu.ops import stft as jstft
from megatts2_hierspeechpp_tpu.train import denoiser as jdnt
from megatts2_hierspeechpp_tpu.train import evalhooks as jev
from megatts2_hierspeechpp_tpu.train.optim import adamw
from tests.test_torch_denoiser import check_phase
from tests.test_torch_kernels import few_torch_threads  # noqa: F401
from tests.test_torch_train_step import _rel_l2, recorder
from tests.test_torch_wav2vec2 import random_vars

SMALL = dict(dense_channel=8, num_tsblocks=2)
CFG = (400, 100, 400, 0.3)   # n_fft, hop, win, compress
N, B = 2000, 2
LOW_OPT = {"xla_backend_optimization_level": 0,
           "xla_llvm_disable_expensive_passes": True}


def jax_variables(seed=50):
    z = np.zeros((1, 4, 201), np.float32)
    return random_vars(JaxMPNet(**SMALL), seed, z, z,
                       collections=("params", "batch_stats"))


def torch_model(variables, **kw):
    tm = TorchMPNet(**SMALL, device="cpu", train=True, **kw)
    tm.load_state_dict(denoiser_from_jax(variables), strict=True)
    return tm


def dn_batch(b=B, seed=51):
    rng = np.random.default_rng(seed)
    clean = rng.uniform(-0.5, 0.5, (b, N)).astype(np.float32)
    noisy = clean + 0.1 * rng.standard_normal((b, N)).astype(np.float32)
    return {"noisy": noisy, "clean": clean}


def jax_spectra(batch):
    """(mag_n, pha_n, mag_c, pha_c) from the JAX front end, as numpy."""
    out = []
    for k in ("noisy", "clean"):
        out += [np.array(a) for a in jstft.mag_pha_stft(jnp.asarray(batch[k]),
                                                          *CFG)]
    return out


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _stats(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


@pytest.fixture(autouse=True)
def _remove_run_dirs(tmp_path):
    """Each test's run directories (checkpoints at published widths) are
    removed once its asserts have run: a whole Tier-1 run would otherwise
    fill a small /tmp."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_phase_losses_match_jax():
    rng = np.random.default_rng(52)
    x = rng.uniform(-20, 20, (3, 7, 11)).astype(np.float32)
    np.testing.assert_allclose(tdnt.anti_wrapping(_t(x)).numpy(),
                               np.asarray(jdnt.anti_wrapping(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    pr, pg = (rng.uniform(-np.pi, np.pi, (2, 9, 13)).astype(np.float32)
              for _ in range(2))
    got = tdnt.phase_losses(_t(pr), _t(pg))
    want = jdnt.phase_losses(jnp.asarray(pr), jnp.asarray(pg))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=0, atol=1e-6)


def test_training_forward_and_batch_stats_match_jax():
    """B = 2 in train() mode: the outputs and the moved running
    statistics against a JAX train=True, mutable=["batch_stats"] apply."""
    variables = jax_variables()
    mag, pha = jax_spectra(dn_batch())[:2]
    (jmag, jpha), mut = jax.jit(lambda v, m, p: JaxMPNet(**SMALL).apply(
        v, m, p, train=True, mutable=["batch_stats"]))(variables, mag, pha)
    tm = torch_model(variables)
    with torch.no_grad():
        tmag, tpha = tm(_t(mag), _t(pha))
    np.testing.assert_allclose(tmag.numpy(), np.asarray(jmag), atol=2e-4, rtol=0)
    check_phase(tpha.numpy(), jpha)
    want = denoiser_from_jax({"params": variables["params"],
                              "batch_stats": mut["batch_stats"]})
    before = denoiser_from_jax(variables)
    got = _stats(tm)
    assert len(got) == 8
    for k, v in got.items():
        assert not torch.equal(v, before[k]), k   # the statistics moved
        w = want[k].numpy()
        assert np.abs(v.numpy() - w).max() <= 1e-5 * np.abs(w).max(), k


def test_serving_build_refuses_a_batch_the_training_build_takes():
    serve = TorchMPNet(**SMALL, device="cpu")
    train = TorchMPNet(**SMALL, device="cpu", train=True)
    x = torch.zeros(2, 4, 201)
    with pytest.raises(ValueError, match="B = 1"):
        serve(x, x)
    assert train(x, x)[0].shape == (2, 4, 201)
    assert all(p.requires_grad for p in train.parameters()) and train.training


def _grad_snapshot(opt, store):
    """Wrap opt.step to keep the gradients as they are before its clip."""
    orig = opt.step

    def step():
        store.extend(p.grad.clone() for p in opt.params)
        orig()

    opt.step = step


def test_denoiser_train_step_matches_jax():
    variables = jax_variables(seed=53)
    batch = dn_batch(seed=54)
    jm = JaxMPNet(**SMALL)
    grads = []
    tx = optax.chain(recorder(grads), adamw(5e-4, max_grad_norm=5.0,
                                            steps_per_epoch=10))
    state = jdnt.DenoiserTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt=tx.init(variables["params"]))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    step = jax.jit(jdnt.make_train_step(jm, tx))
    new_state, want = step.lower(state, jbatch, key).compile(
        compiler_options=LOW_OPT)(state, jbatch, key)
    jax.effects_barrier()
    assert len(grads) == 1

    tm = torch_model(variables)
    tstate = tdnt.create_state(tm, lr=5e-4, max_grad_norm=5.0, steps_per_epoch=10)
    tgrads = []
    _grad_snapshot(tstate.opt, tgrads)
    tstate, got = tdnt.TrainStep(*CFG).with_spectra(
        tstate, *map(_t, jax_spectra(batch)), _t(batch["clean"]))
    assert tstate.step == 1
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-4, err_msg=k)
    names = [k for k, _ in tm.named_parameters()]
    want_g = denoiser_from_jax({"params": grads[0],
                                "batch_stats": variables["batch_stats"]})
    top = max(float(want_g[k].abs().max()) for k in names)
    floor = 1e-6 * top
    want_sd = denoiser_from_jax({"params": new_state.params,
                                 "batch_stats": new_state.batch_stats})
    got_sd = tm.state_dict()
    n_zero = 0
    for k, g in zip(names, tgrads):
        w = want_g[k].numpy()
        live = np.abs(w) > floor   # else zero in exact arithmetic: the
        # biases right before an InstanceNorm / BatchNorm, the key bias
        assert np.abs(g.numpy()[~live]).max(initial=0) <= floor, k
        n_zero += int((~live).sum())
        if live.any():
            assert _rel_l2(g.numpy()[live], w[live]) <= 1e-3, k
            assert _rel_l2(got_sd[k].numpy()[live], want_sd[k].numpy()[live]) <= 1e-3, k
        # Adam's first step moves an entry by at most lr (1 + wd |p|),
        # whatever the sign of the noise
        assert np.abs(got_sd[k].numpy() - want_sd[k].numpy()).max() <= 2 * 5e-4 * 1.001, k
    assert 0 < n_zero < 0.1 * sum(want_g[k].numel() for k in names)
    for k, v in got_sd.items():
        if k.endswith(("running_mean", "running_var")):
            assert _rel_l2(v.numpy(), want_sd[k].numpy()) <= 1e-5, k


def test_call_path_runs_its_own_stft():
    """__call__ (the STFT inside the step, as the CLI runs it): finite
    losses, one step counted."""
    tm = torch_model(jax_variables())
    state = tdnt.create_state(tm, lr=5e-4, max_grad_norm=5.0)
    state, m = tdnt.TrainStep(*CFG)(state, {k: _t(v) for k, v in dn_batch().items()})
    assert state.step == 1 and all(torch.isfinite(v) for v in m.values())


def _loss_grads(model, spectra, clean):
    """The step's loss and gradients without the update."""
    step = tdnt.TrainStep(*CFG)
    state = tdnt.create_state(model, lr=0.0)
    state.opt.step = lambda: None
    _, m = step.with_spectra(state, *spectra, clean)
    return float(m["loss/total"]), [p.grad.clone() for p in model.parameters()]


def test_remat_updates_batch_stats_once():
    """remat checkpoints each TS block; its recompute in the backward runs
    the block again in train() mode. The loss, the gradients and the
    running statistics equal those without remat: a recompute that moved
    the statistics again would leave them a second momentum step away."""
    variables = jax_variables(seed=55)
    batch = dn_batch(seed=56)
    spectra, clean = list(map(_t, jax_spectra(batch))), _t(batch["clean"])
    out = {}
    for remat in (False, True):
        tm = torch_model(variables, remat=remat)
        loss, g = _loss_grads(tm, spectra, clean)
        out[remat] = (loss, g, _stats(tm), tm.state_dict())
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-6)
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    for k, v in out[False][2].items():
        assert torch.equal(out[True][2][k], v), k
    for k, v in out[True][3].items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 1, k


def test_chunked_attention_matches_dense_and_saves_memory():
    """attn_chunk 16 against the dense form, both with remat as the CLI
    runs them: the loss and gradients within JAX's own bounds. Without
    remat, what the chunked form keeps for the backward (each chunk's
    scores are recomputed) is a fraction of what the dense form keeps,
    its largest tensor a fraction of the (N, H, L, L) probabilities."""
    variables = jax_variables(seed=57)
    batch = dn_batch(seed=58)
    spectra, clean = list(map(_t, jax_spectra(batch))), _t(batch["clean"])
    out = {}
    for chunk in (None, 16):
        out[chunk] = _loss_grads(torch_model(variables, remat=True, attn_chunk=chunk),
                                 spectra, clean)
    np.testing.assert_allclose(out[16][0], out[None][0], rtol=1e-6)
    for a, b in zip(out[16][1], out[None][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-3, atol=5e-6)

    saved = {}
    for chunk in (None, 16):
        tm = torch_model(variables, attn_chunk=chunk)
        sizes = []

        def pack(t):
            sizes.append(t.numel())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            tm(spectra[0], spectra[1])
        saved[chunk] = (max(sizes), sum(sizes))
    # the time conformer's scores at B = 2: (21 frames, 4 heads, 200, 200)
    assert saved[None][0] >= 21 * 4 * 200 * 200
    assert saved[16][0] * 4 < saved[None][0]
    assert saved[16][1] * 2 < saved[None][1]


def test_denoiser_eval_fn_matches_jax(monkeypatch, tmp_path):
    """B = 4 held-out batch, the model in eval() mode (running
    statistics); both sides read the JAX front end's spectra."""
    variables = jax_variables(seed=59)
    batch = dn_batch(b=4, seed=60)
    want = jev.make_denoiser_eval_fn(JaxMPNet(**SMALL), batch)(
        type("S", (), {"params": variables["params"],
                       "batch_stats": variables["batch_stats"]}), 1, str(tmp_path))

    def stft(y, *args):
        return tuple(torch.from_numpy(np.array(a)) for a in
                     jstft.mag_pha_stft(jnp.asarray(y.numpy()), *args))

    monkeypatch.setattr(tev.tstft, "mag_pha_stft", stft)
    tm = torch_model(variables)
    before = _stats(tm)
    got = tev.make_denoiser_eval_fn(batch)(type("S", (), {"model": tm}), 1,
                                           str(tmp_path))
    assert tm.training   # back in train() mode, its statistics untouched
    assert all(torch.equal(v, before[k]) for k, v in _stats(tm).items())
    assert got.keys() == want.keys() == {"mag_mse", "snr_improvement_db"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


# ---- the CLI ----

def _write_wavs(d, n=6, seed=61):
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        t = np.arange(3000 + 37 * i) / 16000.0
        w = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 1000) * t)
        wavfile.write(os.path.join(d, f"c{i}.wav"), 16000, (w * 32767).astype(np.int16))


def test_wavs_noise_and_batches_equal_jax(tmp_path):
    """load_wavs, _noise_like (one FIR pass, not a recursion) and
    make_batch_iter against the JAX CLI's, array for array."""
    _write_wavs(str(tmp_path))
    wt, wj = tcli.load_wavs(str(tmp_path)), jcli.load_wavs(str(tmp_path))
    assert len(wt) == len(wj) == 6
    assert all(np.array_equal(a, b) for a, b in zip(wt, wj))
    a = tcli._noise_like(np.random.default_rng(3), 4000)
    b = jcli._noise_like(np.random.default_rng(3), 4000)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    args = (3, 2000, 0.0, 15.0, 7, 3)
    for epoch in (0, 2):
        for bt, bj in zip(tcli.make_batch_iter(wt, *args)(epoch),
                          jcli.make_batch_iter(wj, *args)(epoch)):
            for k in ("clean", "noisy"):
                assert bt[k].dtype == bj[k].dtype and np.array_equal(bt[k], bj[k]), k


def _scalars(model_dir):
    with open(os.path.join(model_dir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_restart_equals_straight_run(tmp_path):
    """cli/train_denoiser at dense_channel 8 with the CLI's remat and
    attn_chunk: 2 steps, a restart from the epoch-end checkpoint, 2 more,
    against 4 straight: the same losses; the eval scalars at steps 2 and 4;
    the running statistics saved and restored."""
    data = str(tmp_path / "data")
    _write_wavs(data)
    common = ["--data_dir", data, "--batch_size", "2", "--seg", "2000",
              "--dense_channel", "8", "--steps_per_epoch", "2",
              "--eval_interval", "2", "--log_interval", "1", "--device", "cpu",
              "--logs_dir", str(tmp_path / "logs")]
    straight = tcli.main(common + ["-m", "a", "--epochs", "2"])
    tcli.main(common + ["-m", "b", "--epochs", "1"])
    resumed = tcli.main(common + ["-m", "b", "--epochs", "2"])
    assert straight.step == resumed.step == 4
    assert straight.model.remat and straight.model.TSConformer[0] \
        .time_conformer.attn.attn.attn_chunk == 64
    a, b = (_scalars(str(tmp_path / "logs" / m)) for m in ("a", "b"))
    loss_a = {r["step"]: r for r in a if "loss/total" in r}
    loss_b = {r["step"]: r for r in b if "loss/total" in r}
    assert sorted(loss_a) == sorted(loss_b) == [1, 2, 3, 4]
    for s, r in loss_a.items():
        for k, v in r.items():
            if k.startswith("loss/"):
                np.testing.assert_allclose(loss_b[s][k], v, rtol=1e-6,
                                           err_msg=f"step {s} {k}")
    evals = [r for r in a if "eval/mag_mse" in r]
    assert [r["step"] for r in evals] == [2, 4]
    assert all(np.isfinite(r["eval/mag_mse"]) and np.isfinite(r["eval/snr_improvement_db"])
               for r in evals)
    for k, v in _stats(straight.model).items():
        torch.testing.assert_close(_stats(resumed.model)[k], v, rtol=1e-6, atol=0)
