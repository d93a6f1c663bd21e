"""The port's AR trainer (ar/scaled_adam.py, ar/dataset.py, ar/trainer.py,
train/evalhooks.make_ar_eval_fn, cli/train_ar.py) against the JAX package
on the CPU:

  - ScaledAdam's updates against the JAX transformation on a tree with a
    scalar-ish tensor, a 1-D tensor over 4096 elements and both ends of the
    RMS clip, three updates on the warmup-cosine schedule (1e-6 relative);
    the schedule at steps 0, 1, warmup, mid and total (1e-6 relative);
  - Text2SemanticDataset / collate equal to JAX's on the cases of
    tests/test_ar_trainer.py and tests/test_prepare_datasets.py (BERT
    sidecars included);
  - six micro-steps at grad_accum 2 against JAX make_train_step from the
    same params: metrics 1e-4 relative, params and moments after each
    update 1e-4 relative L2 (test_torch_ar.py's small model), the key
    third of in_proj_bias left out of the params once both sides show its
    gradient at rounding level;
  - the eval hook against JAX make_ar_eval_fn;
  - cli/train_ar.main with --device cpu at the CLI's widths on a tiny
    corpus: 2 micro-steps, a restart, 2 more equal 4 straight micro-steps
    within 1e-6 relative at grad_accum 4 (the checkpoint after micro-step
    2 holds a half-filled accumulation buffer)."""
import json
import shutil
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from megatts2_hierspeechpp_torch.ar import dataset as tds
from megatts2_hierspeechpp_torch.ar import trainer as ttrainer
from megatts2_hierspeechpp_torch.ar.scaled_adam import (
    ScaledAdam,
    warmup_cosine_schedule,
)
from megatts2_hierspeechpp_torch.cli import train_ar as cli_ar
from megatts2_hierspeechpp_torch.convert import t2s_from_jax
from megatts2_hierspeechpp_torch.data import text as ttext
from megatts2_hierspeechpp_torch.train import checkpoints as ckpt_lib
from megatts2_hierspeechpp_torch.train.evalhooks import make_ar_eval_fn
from megatts2_hierspeechpp_tpu.ar import dataset as jds
from megatts2_hierspeechpp_tpu.ar import scaled_adam as jsa
from megatts2_hierspeechpp_tpu.ar import t2s as jt2s
from megatts2_hierspeechpp_tpu.ar import trainer as jtrainer
from megatts2_hierspeechpp_tpu.train.evalhooks import make_ar_eval_fn as jeval
from tests.test_torch_ar import KEYS, SMALL, as_jax, port_model, rel_l2, torch_args
from tests.test_torch_kernels import few_torch_threads  # noqa: F401

SCHED = (1e-4, 1e-2, 1e-4, 2, 10)   # init, peak, end, warmup, total


def test_schedule_matches_jax():
    js = jsa.warmup_cosine_schedule(*SCHED)
    ts = warmup_cosine_schedule(*SCHED)
    for step in (0, 1, 2, 6, 10):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6)


def test_scaled_adam_updates_match_jax():
    rng = np.random.default_rng(0)
    tree = {
        "scalarish": rng.standard_normal(3),
        "long_1d": rng.standard_normal(5000),          # 1-D over 4096: RMS-scaled
        "below_min_rms": 1e-7 * rng.standard_normal((8, 8)),
        "above_max_rms": 10.0 * rng.standard_normal((4, 6)),
        "weight": 0.3 * rng.standard_normal((16, 8)),
    }
    tree = {k: v.astype(np.float32) for k, v in tree.items()}
    tx = jsa.scaled_adam(learning_rate=jsa.warmup_cosine_schedule(*SCHED))
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    jstate = tx.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in tree.values()]
    opt = ScaledAdam(params, lr=warmup_cosine_schedule(*SCHED))
    for i in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in tree.items()}
        upd, jstate = tx.update({k: jnp.asarray(g) for k, g in grads.items()},
                                jstate, jp)
        jp = optax.apply_updates(jp, upd)
        got = opt.updates([torch.from_numpy(g) for g in grads.values()])
        with torch.no_grad():
            for p, u in zip(params, got):
                p.add_(u)
        for k, u in zip(tree, got):   # (JAX orders a dict's leaves by key)
            want = np.asarray(upd[k])
            np.testing.assert_allclose(u.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=f"{k} update {i}")


def write_tables(d, phones: dict, semantic: dict):
    with open(d / "2-name2text.txt", "w", encoding="utf-8") as f:
        f.writelines(f"{k}\t{v}\n" for k, v in phones.items())
    with open(d / "6-name2semantic.tsv", "w", encoding="utf-8") as f:
        f.writelines(f"{k}\t{' '.join(map(str, v))}\n" for k, v in semantic.items())
    return str(d / "2-name2text.txt"), str(d / "6-name2semantic.tsv")


def assert_batches_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("case", ["unknown symbol", "bert sidecars"])
def test_dataset_and_collate_match_jax(tmp_path, case):
    if case == "unknown symbol":   # tests/test_ar_trainer.py's case
        paths = write_tables(tmp_path, {"a": "x y z", "b": "x x", "c": "bad_symbol"},
                             {"a": range(30), "b": range(12), "c": [1, 2, 3]})
        vocab, bert_dir = {"x": 1, "y": 2, "z": 3}, None
    else:                          # tests/test_prepare_datasets.py's case
        paths = write_tables(tmp_path, {"u1": "sil a b", "u2": "sil c"},
                             {"u1": [3] * 30, "u2": [5] * 10})
        (tmp_path / "3-bert").mkdir()
        np.save(tmp_path / "3-bert" / "u1.npy", np.ones((3, 1024), np.float32) * 7)
        vocab, bert_dir = {"sil": 1, "a": 2, "b": 3, "c": 4}, str(tmp_path / "3-bert")
    jd = jds.Text2SemanticDataset(*paths, vocab, bert_dir=bert_dir)
    td = tds.Text2SemanticDataset(*paths, vocab, bert_dir=bert_dir)
    assert len(td) == len(jd) == 2 and td.lengths() == jd.lengths()
    for pm in (8, 64):
        assert_batches_equal(tds.collate([td[0], td[1]], pad_multiple=pm),
                             jds.collate([jd[0], jd[1]], pad_multiple=pm))


def micro_batches(n=3, seed=20):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append(dict(x_ids=rng.integers(0, 50, (2, 8)).astype(np.int32),
                        x_lens=np.array([8, 6], np.int32),
                        y_ids=rng.integers(0, 100, (2, 16)).astype(np.int32),
                        y_lens=np.array([16, 11], np.int32),
                        bert_feature=rng.standard_normal((2, 8, 1024)).astype(np.float32)))
    return out


KEY_ROUNDING = 1e-6   # a gradient at rounding level: about 8 float32 ulps of
                      # the largest query / value bias gradient


def key_third(v):
    d = v.shape[0] // 3
    return v[d:2 * d], np.concatenate([v[:d], v[2 * d:]])


def assert_key_bias_grads_at_rounding(jm, params, batches):
    """The key third of in_proj_bias has a true gradient of 0 (a softmax row
    is invariant to a shift of its scores, which is what a key bias adds):
    on every micro-batch, JAX's and the port's gradients of that third are
    within KEY_ROUNDING of the largest query / value bias gradient. Adam's
    m / sqrt(v) turns such noise into steps of about lr, so the params'
    comparison leaves that third out (without_key_bias)."""
    grad = jax.jit(jax.grad(lambda p, b: jm.apply(
        {"params": p}, *(b[k] for k in KEYS))["loss"]))
    for i, b in enumerate(batches):
        want = t2s_from_jax(grad(params, b))
        ref = port_model(train=True)
        ref(*torch_args(b))["loss"].backward()
        for n, p in ref.named_parameters():
            if n.endswith("in_proj_bias"):
                for side, g in (("jax", want[n].numpy()), ("port", p.grad.numpy())):
                    key, qv = key_third(g)
                    assert np.abs(key).max() <= KEY_ROUNDING * np.abs(qv).max(), (
                        side, n, i)


def without_key_bias(got, want):
    return key_third(got)[1], key_third(want)[1]


def test_accumulated_micro_steps_match_jax():
    tm = port_model(train=True)
    jm = jt2s.Text2Semantic(**SMALL, p_dropout=0.0)
    params = as_jax(tm)
    tx = jsa.scaled_adam(learning_rate=jsa.warmup_cosine_schedule(*SCHED))
    jstate = jtrainer.ARTrainState(
        step=jnp.zeros((), jnp.int32), params=params, opt=tx.init(params),
        accum=jax.tree.map(jnp.zeros_like, params),
        accum_count=jnp.zeros((), jnp.int32))
    jstep = jax.jit(jtrainer.make_train_step(jm, tx, grad_accum=2))
    state = ttrainer.create_state(
        tm, ScaledAdam(tm.parameters(), lr=warmup_cosine_schedule(*SCHED)))
    step = ttrainer.TrainStep(grad_accum=2)
    names = [n for n, _ in tm.named_parameters()]
    batches = micro_batches()
    assert_key_bias_grads_at_rounding(jm, params, batches)
    for i in range(6):
        b = batches[i % 3]
        jstate, jm_ = jstep(jstate, b, jax.random.PRNGKey(i))
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                        torch.Generator().manual_seed(i))
        assert state.step == i + 1 and state.accum_count == int(jstate.accum_count)
        for k in ("loss/t2s", "acc/t2s"):
            np.testing.assert_allclose(float(m[k]), float(jm_[k]), rtol=1e-4,
                                       err_msg=f"{k} at micro-step {i + 1}")
        if state.accum_count:
            continue
        want = {"params": t2s_from_jax(jstate.params),
                "mu": t2s_from_jax(jstate.opt.mu), "nu": t2s_from_jax(jstate.opt.nu)}
        got = {"params": dict(tm.named_parameters()),
               "mu": dict(zip(names, state.opt.mu)), "nu": dict(zip(names, state.opt.nu))}
        for tree in want:
            for n in names:
                g, w = got[tree][n].detach().numpy(), want[tree][n].numpy()
                if tree == "params" and n.endswith("in_proj_bias"):
                    g, w = without_key_bias(g, w)
                assert rel_l2(g, w) < 1e-4, (tree, n, i + 1)
    assert state.opt.count == 3


class _JaxState:
    def __init__(self, params):
        self.params = params


def test_eval_hook_matches_jax():
    tm = port_model()
    jm = jt2s.Text2Semantic(**SMALL, p_dropout=0.0)
    batch = micro_batches(1, seed=30)[0]
    want = jeval(jm, batch)(_JaxState(as_jax(tm)), 0, "")
    got = make_ar_eval_fn(batch)(ttrainer.create_state(
        tm, ScaledAdam([torch.nn.Parameter(torch.zeros(1))])), 0, "")
    assert got.keys() == want.keys() == {"t2s_loss", "t2s_acc_top10"}
    np.testing.assert_allclose(got["t2s_loss"], want["t2s_loss"], rtol=1e-5)
    assert got["t2s_acc_top10"] == want["t2s_acc_top10"]


# ---------- the CLI ----------


def tiny_corpus(d, n=4, seed=40):
    """n items of 10-14 phones and 40-60 semantic tokens (one bucket)."""
    rng = np.random.default_rng(seed)
    phones, semantic = {}, {}
    for i in range(n):
        ids = rng.integers(0, ttext.N_VOCAB, rng.integers(10, 15))
        phones[f"utt{i:04d}"] = " ".join(ttext.SYMBOLS[j] for j in ids)
        semantic[f"utt{i:04d}"] = rng.integers(0, 1024, rng.integers(40, 61)).tolist()
    return write_tables(d, phones, semantic)


@pytest.fixture(scope="module")
def ar_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ar")
    ph, sem = tiny_corpus(d)
    logs = str(d / "logs")

    def run(name, epochs):
        return cli_ar.main(["--phoneme_path", ph, "--semantic_path", sem,
                            "-m", name, "--logs_dir", logs, "--batch_size", "2",
                            "--epochs", str(epochs), "--log_interval", "1",
                            "--device", "cpu"])

    a = run("a", 2)
    b1 = run("b", 1)
    b1_step, b1_count = b1.step, b1.accum_count
    b1_accum = [t.clone() for t in b1.accum]
    b = run("b", 2)
    yield logs, a, (b1_step, b1_count, b1_accum), b
    shutil.rmtree(d, ignore_errors=True)  # the runs' checkpoints, 2.4 GB


def test_train_ar_cli_restart_inside_accumulation(ar_runs):
    logs, a, (b1_step, b1_count, b1_accum), b = ar_runs
    assert (a.step, b1_step, b.step) == (4, 2, 4)
    assert b1_count == 2 and any(float(t.abs().max()) > 0 for t in b1_accum)
    assert a.opt.count == b.opt.count == 1 and a.accum_count == b.accum_count == 0
    saved = ckpt_lib.restore_raw(os.path.join(logs, "b", "ckpt"), 2)
    assert saved["accum_count"] == 2
    for s, t in zip(saved["accum"], b1_accum):
        assert torch.equal(s, t)
    for sa, sb in ((a.state_dict()["model"], b.state_dict()["model"]),
                   (dict(enumerate(a.opt.mu + a.opt.nu)),
                    dict(enumerate(b.opt.mu + b.opt.nu)))):
        for k in sa:
            np.testing.assert_allclose(sb[k].numpy(), sa[k].numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=str(k))
    with open(os.path.join(logs, "a", "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    for r in recs:
        assert {"loss/t2s", "acc/t2s"} <= r.keys()
        assert all(np.isfinite(v) for v in r.values())


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only case")
def test_train_ar_cli_raises_without_cuda():
    """--device defaults to cuda: without CUDA the CLI raises before it
    reads anything, it does not move to the CPU."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_ar.main(["--phoneme_path", "x", "--semantic_path", "y", "-m", "z"])
