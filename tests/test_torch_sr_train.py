"""SpeechSR training in the port (models/speechsr.SpeechSR(train=True),
train/speechsr.py, train/evalhooks.make_sr_eval_fn, cli/train_sr.py)
against the JAX package on the CPU.

Small configuration (as JAX tests/test_train_misc.py): SpeechSR ch 16,
seg_in 1600, B = 2; the discriminator at resolution (128, 32, 128) and
period 2; the step's mel at n_fft 512, hop 128, 64 bins. Weights are seeded
random JAX trees at nn/init.py's scales, carried over by
convert.*_from_jax. On the CPU the JAX generator runs its plain modules and
the port's its stage through the plain version of fused_amp_triple.

Tolerances: every metric within 1e-4 relative; G and D gradients and the
updated parameters within 1e-3 relative L2 per tensor (tensors whose
gradient norm is above 1e-6 of the largest; float32 sums in another order
through two backward passes); the training build's forward against the
serving build's within 1e-5; the eval scalars within 1e-4 relative; the
stage's gradients against jax.grad within rtol 1e-4, atol 1e-4 x the
largest; batches and the resumed run's losses equal."""
import json
import os
import shutil

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import megatts2_hierspeechpp_tpu.ops.pallas_amp_triple as pat
from megatts2_hierspeechpp_torch.cli import train_sr as tcli
from megatts2_hierspeechpp_torch.convert import mpd_from_jax, speechsr_from_jax
from megatts2_hierspeechpp_torch.models import speechsr as tsr_mod
from megatts2_hierspeechpp_torch.models.discriminators import (
    MultiPeriodDiscriminator as TorchMPD,
)
from megatts2_hierspeechpp_torch.models.speechsr import SpeechSR as TorchSR
from megatts2_hierspeechpp_torch.ops import amp_triple, cuda_lib
from megatts2_hierspeechpp_torch.train import evalhooks as tev
from megatts2_hierspeechpp_torch.train import speechsr as tsrt
from megatts2_hierspeechpp_tpu.cli import train_sr as jcli
from megatts2_hierspeechpp_tpu.models.discriminators import (
    MultiPeriodDiscriminator as JaxMPD,
)
from megatts2_hierspeechpp_tpu.models.speechsr import SpeechSR as JaxSR
from megatts2_hierspeechpp_tpu.train import evalhooks as jev
from megatts2_hierspeechpp_tpu.train import speechsr as jsrt
from megatts2_hierspeechpp_tpu.train.optim import adamw
from tests.test_torch_kernels import (  # noqa: F401  (fixtures)
    DIL,
    _block_ws,
    few_torch_threads,
    interpret_pallas,
)
from tests.test_torch_train_modules import random_tree
from tests.test_torch_train_step import _check_grads, _rel_l2, recorder

CH, SEG_IN, B = 16, 1600, 2
MPD_SR = dict(resolutions=((128, 32, 128),), periods=(2,))
MEL = dict(n_fft=512, hop=128, n_mels=64)
RATES = {48000: (3, 1), 24000: (3, 2)}
LOW_OPT = {"xla_backend_optimization_level": 0,
           "xla_llvm_disable_expensive_passes": True}


def sr_pair(out_sr, seed=40):
    """(JAX SpeechSR, its params, the port's training build with them)."""
    num, den = RATES[out_sr]
    jm = JaxSR(upsample_initial_channel=CH, rate_num=num, rate_den=den)
    params = random_tree(jm.init, seed, np.zeros((1, SEG_IN, 1), np.float32))
    tm = TorchSR(CH, num, den, device="cpu", train=True)
    tm.load_state_dict(speechsr_from_jax(params), strict=True)
    return jm, params, tm


def sr_batch(out_sr, b=B, seed=41):
    """A bandlimited lo (sums of sines below 2 kHz) and its exact
    upsampled hi, plus a little noise in hi."""
    num, den = RATES[out_sr]
    rng = np.random.default_rng(seed)
    t_lo = np.arange(SEG_IN) / 16000.0
    t_hi = np.arange(SEG_IN * num // den) / (16000.0 * num / den)
    lo, hi = [], []
    for _ in range(b):
        f = rng.uniform(100, 2000, 4)
        a = rng.uniform(0.02, 0.1, 4)
        lo.append((a[:, None] * np.sin(2 * np.pi * f[:, None] * t_lo)).sum(0))
        hi.append((a[:, None] * np.sin(2 * np.pi * f[:, None] * t_hi)).sum(0)
                  + 0.005 * rng.standard_normal(t_hi.size))
    return {"lo": np.stack(lo)[..., None].astype(np.float32),
            "hi": np.stack(hi)[..., None].astype(np.float32)}


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.fixture(autouse=True)
def _remove_run_dirs(tmp_path):
    """Each test's run directories (checkpoints at published widths) are
    removed once its asserts have run: a whole Tier-1 run would otherwise
    fill a small /tmp."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("out_sr", [48000, 24000])
def test_sr_train_step_matches_jax(out_sr):
    jm, params_g, gen = sr_pair(out_sr)
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
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    step = jax.jit(jsrt.make_train_step(jm, jd, tx_g, tx_d, sr_out=out_sr, **MEL))
    new_state, want = step.lower(state, jbatch, key).compile(
        compiler_options=LOW_OPT)(state, jbatch, key)
    jax.effects_barrier()
    assert len(grads_g) == len(grads_d) == 1

    disc = TorchMPD(**MPD_SR, device="cpu")
    disc.load_state_dict(mpd_from_jax(params_d), strict=True)
    tstate = tsrt.create_state(gen, disc, lr=1e-4, steps_per_epoch=10)
    tstate, got = tsrt.TrainStep(sr_out=out_sr, **MEL)(
        tstate, {k: _t(v) for k, v in batch.items()})

    assert tstate.step == 1
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-4, err_msg=k)
    _check_grads({k: p.grad for k, p in gen.named_parameters()},
                 speechsr_from_jax(grads_g[0]))
    _check_grads({k: p.grad for k, p in disc.named_parameters()},
                 mpd_from_jax(grads_d[0]))
    for module, conv, tree in ((gen, speechsr_from_jax, new_state.params_g),
                               (disc, mpd_from_jax, new_state.params_d)):
        want_p = conv(tree)
        for k, p in module.state_dict().items():
            assert _rel_l2(p.numpy(), want_p[k].numpy()) <= 1e-3, k


@pytest.mark.parametrize("out_sr", [48000, 24000])
def test_training_build_forward_equals_serving(out_sr):
    """The training build (trainable, the triple under autograd) gives the
    serving build's output from the same weights and seed."""
    num, den = RATES[out_sr]
    train = TorchSR(CH, num, den, seed=3, device="cpu", train=True)
    serve = TorchSR(CH, num, den, seed=3, device="cpu")
    assert all(p.requires_grad for p in train.parameters())
    assert not any(p.requires_grad for p in serve.parameters())
    x = _t(sr_batch(out_sr)["lo"])
    y = train(x)
    assert y.requires_grad
    torch.testing.assert_close(y.detach(), serve(x), rtol=0, atol=1e-5)


def test_stage_tail_gradient_matches_jax_c32(interpret_pallas):
    """The SR stage with its tail at C = 32: x, the three blocks' weights
    and the tail's alpha, 1/beta and conv_post weight, through plain_vjp
    (the kernel's backward) against jax.grad of the JAX fused_amp_triple."""
    rng = np.random.default_rng(43)
    c, ks = 32, (3, 7, 11)
    x = rng.standard_normal((2, 96, c)).astype(np.float32)
    bws = [_block_ws(rng, k, c) for k in ks]
    post = [np.exp(rng.normal(0, 0.2, c)).astype(np.float32),
            np.exp(rng.normal(0, 0.2, c)).astype(np.float32),
            (rng.standard_normal((7, c)) * 0.1 / np.sqrt(7 * c)).astype(np.float32)]
    cot = rng.standard_normal((2, 96, 1)).astype(np.float32)
    flat = [w for bw in bws for w in bw] + post

    def jloss(x_, *flat_):
        bw = [flat_[8 * i: 8 * i + 8] for i in range(3)]
        return jnp.sum(cot * pat.fused_amp_triple(x_, bw, ks, (DIL,) * 3,
                                                  post=tuple(flat_[24:])))

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(1 + len(flat)))))(
        jnp.asarray(x), *map(jnp.asarray, flat))
    got = cuda_lib.plain_vjp(amp_triple._composed_flat, [_t(x)] + [_t(w) for w in flat],
                             (True,) * (1 + len(flat)), _t(cot), ks, (DIL,) * 3, True)
    assert len(got) == len(want) == 28
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


def test_stage_function_routes_gradients_to_every_parameter(monkeypatch):
    """SpeechSR(train=True) at C = 32 with the stage through _AMPTriple
    (its launch replaced by the plain version, as on the card): the
    gradients of every parameter, conv_pre's weight norm, the blocks,
    activation_post's alpha / beta and conv_post (through the transposed
    copy) equal those of the unfused module path."""
    gen = TorchSR(32, 3, 1, seed=6, device="cpu", train=True)
    with torch.no_grad():
        for p in gen.activation_post.parameters():
            p.normal_(0, 0.2)
    x = _t(sr_batch(48000, b=1)["lo"][:, :400])
    cot = torch.randn((1, 1200, 1), generator=torch.Generator().manual_seed(7))

    def grads():
        gen.zero_grad(set_to_none=True)
        gen(x).backward(cot)
        return {k: p.grad.clone() for k, p in gen.named_parameters()}

    monkeypatch.setattr(amp_triple, "_launch", lambda x_, bws, d, post, packed=None:
                        amp_triple.composed_triple(x_, bws, gen.ks, d, post))
    monkeypatch.setattr(cuda_lib, "LAUNCHES", dict.fromkeys(cuda_lib.LAUNCHES, 0))

    def through_function(y, block_ws, ks, dils, post=None, packed=None):
        flat = [w for bw in block_ws for w in bw] + list(post)
        return amp_triple._AMPTriple.apply(y.contiguous(), tuple(ks), dils, True,
                                           None, *flat)

    monkeypatch.setattr(tsr_mod, "fused_amp_triple", through_function)
    got = grads()
    assert cuda_lib.LAUNCHES["amp_triple"] == 1
    monkeypatch.setattr(tsr_mod, "fused_triple_enabled", lambda c: False)
    want = grads()
    assert got.keys() == want.keys()
    assert {"conv_pre.weight_g", "activation_post.act.alpha",
            "activation_post.act.beta", "conv_post.weight"} <= got.keys()
    for k, w in want.items():
        assert w.abs().max() > 0, k
        torch.testing.assert_close(got[k], w, rtol=1e-5, atol=1e-6 * w.abs().max().item(),
                                   msg=k)


def test_sr_eval_fn_matches_jax(tmp_path):
    jm, params, gen = sr_pair(48000, seed=44)
    batch = sr_batch(48000, b=4, seed=45)
    want = jev.make_sr_eval_fn(jm, batch, 48000, plot=False)(
        type("S", (), {"params_g": params}), 1, str(tmp_path))
    state = type("S", (), {"gen": gen})
    got = tev.make_sr_eval_fn(batch, 48000)(state, 7, str(tmp_path))
    assert got.keys() == want.keys() == {"mel_l1", "snr_db"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert sorted(os.listdir(tmp_path / "eval")) == ["sr_gt_7.png", "sr_pred_7.png"]


# ---- the CLI ----

def _write_wavs(d, n=6, seconds=0.5, seed=46):
    """n bandlimited 16 kHz wavs of odd lengths, and a trans.txt listing
    them in another order (the synthetic corpus's layout)."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    paths = []
    for i in range(n):
        t = np.arange(int(16000 * seconds) + 2 * i + 1) / 16000.0
        f = rng.uniform(100, 1500, 3)
        w = (0.2 * np.sin(2 * np.pi * f[:, None] * t)).sum(0) / 3
        paths.append(os.path.join(d, f"w{i}.wav"))
        wavfile.write(paths[-1], 16000, (w * 32767).astype(np.int16))
    return paths


@pytest.mark.parametrize("layout", ["trans", "wavs"])
@pytest.mark.parametrize("out_sr", [48000, 24000])
def test_corpus_and_batches_equal_jax(tmp_path, layout, out_sr):
    paths = _write_wavs(str(tmp_path))
    if layout == "trans":
        with open(tmp_path / "trans.txt", "w") as f:
            f.write("".join(f"{p}|spk|text\n" for p in reversed(paths)))
    num, den = RATES[out_sr]
    lo_t, hi_t = tcli.load_corpus(str(tmp_path), None, num, den)
    lo_j, hi_j = jcli.load_corpus(str(tmp_path), None, num, den)
    assert len(lo_t) == len(lo_j) == 6
    for a, b in zip(lo_t + hi_t, lo_j + hi_j):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    assert all(len(lo) % den == 0 for lo in lo_t)
    args = (4, 1600, num, den, 9, 3)
    for epoch in (0, 1):
        for bt, bj in zip(tcli.make_batch_iter(lo_t, hi_t, *args)(epoch),
                          jcli.make_batch_iter(lo_j, hi_j, *args)(epoch)):
            for k in ("lo", "hi"):
                assert np.array_equal(bt[k], bj[k]), (epoch, k)


def _scalars(model_dir):
    with open(os.path.join(model_dir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_restart_equals_straight_run(tmp_path):
    """cli/train_sr at ch 16 (the 48 kHz discriminator bank): 2 steps, a
    restart from the epoch-end checkpoint, 2 more, against 4 straight: the
    same losses at every step; the eval scalars and PNGs at steps 2 and 4."""
    data = str(tmp_path / "data")
    _write_wavs(data)
    common = ["--data_dir", data, "--batch_size", "2", "--seg_in", "1600",
              "--ch", "16", "--steps_per_epoch", "2", "--eval_interval", "2",
              "--log_interval", "1", "--device", "cpu", "--logs_dir",
              str(tmp_path / "logs")]
    straight = tcli.main(common + ["-m", "a", "--epochs", "2"])
    tcli.main(common + ["-m", "b", "--epochs", "1"])
    resumed = tcli.main(common + ["-m", "b", "--epochs", "2"])
    assert straight.step == resumed.step == 4
    a, b = (_scalars(str(tmp_path / "logs" / m)) for m in ("a", "b"))
    loss_a = {r["step"]: r for r in a if "loss/g/total" in r}
    loss_b = {r["step"]: r for r in b if "loss/g/total" in r}
    assert sorted(loss_a) == sorted(loss_b) == [1, 2, 3, 4]
    for s, r in loss_a.items():
        for k, v in r.items():
            if k.startswith("loss/"):
                np.testing.assert_allclose(loss_b[s][k], v, rtol=1e-6,
                                           err_msg=f"step {s} {k}")
    evals = [r for r in a if "eval/mel_l1" in r]
    assert [r["step"] for r in evals] == [2, 4]
    assert all(np.isfinite(r["eval/mel_l1"]) and np.isfinite(r["eval/snr_db"])
               for r in evals)
    assert "sr_pred_4.png" in os.listdir(tmp_path / "logs" / "a" / "eval")
