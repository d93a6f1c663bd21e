"""The port's data-parallel plumbing (parallel/mesh.py, parallel/dryrun.py)
on the CPU, with gloo ranks spawned through a FileStore under tmp_path (or
the launcher's variables on a free port):

  - without a process group every reduction is the identity and the
    trainers' paths are unchanged: GlobalBatchNorm1d is nn.BatchNorm1d,
    MaskSource draws the local shape, init_distributed returns the asked
    device and refuses CUDA where there is none;
  - init_distributed from torchrun's variables (gloo for the CPU), the
    all-reduce smoke of tools/smoke_distributed.py, pad_to_global;
  - GlobalBatchNorm1d at world 2 equals BatchNorm1d over the whole batch:
    output, input and parameter gradients, running statistics (1e-5);
  - the dry run: one step of s2, s1, the vocoder and AR (grad_accum 2) at
    world 2 with every rank's state bitwise equal, and the tensor-parallel
    ProsodyLM decode equal to the one-card decode; on the card unless the
    caller asks for the CPU (without CUDA its entry points raise);
  - one step of cli/train_denoiser under the launcher's variables at world
    2, batch 1 a rank, equals world 1 at batch 2 (losses 1e-4 relative,
    the BatchNorm statistics 1e-4 relative L2, every weight within the
    2 x lr that Adam's first step can take on a gradient at rounding level,
    both ranks bitwise equal), one scalar record and one checkpoint written
    by rank 0."""
import json
import os
import socket

import numpy as np
import pytest
import torch

from megatts2_hierspeechpp_torch.cli import train_denoiser
from megatts2_hierspeechpp_torch.nn.basic import MaskSource, dropout_masks
from megatts2_hierspeechpp_torch.parallel import dryrun, mesh
from megatts2_hierspeechpp_torch.parallel.dryrun import (
    allreduce_smoke,
    dryrun_multichip,
    spawn,
)
from tests import torch_dp_ranks as ranks
from tests.test_torch_denoiser_train import _write_wavs
from tests.test_torch_train_step import _rel_l2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_without_a_process_group_everything_is_local():
    assert (mesh.world(), mesh.rank(), mesh.is_main()) == (1, 0, True)
    x = torch.randn(4, 3)
    with mesh.global_batch():
        assert not mesh.sharded() and mesh.shard() == (0, 1)
        assert mesh.all_sum([x])[0] is x and mesh.batch_sum(x) is x
        assert mesh.gather_rows(x) is x and mesh.local_rows(x) is x
        assert mesh.share_denominator(x.sum()) is not None
        p = torch.nn.Parameter(torch.ones(3))
        p.grad = torch.full((3,), 2.0)
        mesh.reduce_grads([p])
        assert torch.equal(p.grad, torch.full((3,), 2.0))
        m = {"a": torch.tensor(1.0)}
        assert mesh.reduce_metrics(m) is m
    batch = {"a": np.zeros((2, 3), np.float32)}
    assert mesh.pad_to_global(batch) is batch
    assert mesh.init_distributed("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh.init_distributed("cuda")


def test_global_batchnorm_is_batchnorm_at_world_1():
    torch.manual_seed(0)
    ref, got = torch.nn.BatchNorm1d(6), mesh.GlobalBatchNorm1d(6)
    got.load_state_dict(ref.state_dict())
    x = torch.randn(5, 6, 7)
    with mesh.global_batch():
        np.testing.assert_array_equal(got(x).detach().numpy(),
                                      ref(x).detach().numpy())
    for k, v in ref.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k


def test_mask_source_draws_the_local_shape_without_a_group():
    a = MaskSource(torch.Generator().manual_seed(3))
    b = MaskSource(torch.Generator().manual_seed(3))
    with mesh.global_batch(), dropout_masks(a):
        ka = a.keep((2, 5), 0.5, "cpu")
    kb = b.keep((2, 5), 0.5, "cpu")
    assert ka.shape == (2, 5) and torch.equal(ka, kb)


def test_init_distributed_from_launcher_variables(tmp_path):
    got = spawn(ranks.env_init_rank, 2, (free_port(),), store_dir=str(tmp_path),
                init_group=False)
    for r, g in enumerate(got):
        assert g == {"device": "cpu", "world": 2, "rank": r, "main": r == 0,
                     "backend": "gloo", "sum": 3.0}


def test_allreduce_smoke(tmp_path):
    assert spawn(allreduce_smoke, 2, ("cpu",),
                 store_dir=str(tmp_path)) == [24.0, 24.0]


def test_dryrun_defaults_to_the_card_and_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: dryrun.main([]), dryrun_multichip,
                lambda: allreduce_smoke(0, 1),
                lambda: dryrun.tp_decode_check(0, 1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()


def test_pad_to_global(tmp_path):
    shapes = {"a": [(2, 3), (2, 5)], "b": [(2, 4, 1), (2, 2, 1)]}
    got = spawn(ranks.pad_rank, 2, (shapes,), store_dir=str(tmp_path))
    for r, g in enumerate(got):
        assert g["a"].shape == (2, 5) and g["b"].shape == (2, 4, 1)
        s = shapes["a"][r]
        assert (g["a"][:, :s[1]] == r + 1).all() and (g["a"][:, s[1]:] == 0).all()


def test_global_batchnorm_at_world_2_is_batchnorm_of_the_whole_batch(tmp_path):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 3, 5)).astype(np.float32) * 2 + 1
    w = rng.standard_normal((4, 3, 5)).astype(np.float32)
    b = rng.standard_normal((2, 3)).astype(np.float32)
    ref = torch.nn.BatchNorm1d(3)
    with torch.no_grad():
        ref.weight.copy_(torch.from_numpy(b[0]))
        ref.bias.copy_(torch.from_numpy(b[1]))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = ref(xt)
    (y * torch.from_numpy(w)).sum().backward()
    got = spawn(ranks.bn_rank, 2, (x, w, b), store_dir=str(tmp_path))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([g["y"] for g in got]),
                               y.detach().numpy(), **tol)
    np.testing.assert_allclose(np.concatenate([g["dx"] for g in got]),
                               xt.grad.numpy(), **tol)
    for g in got:
        np.testing.assert_allclose(g["dw"], ref.weight.grad.numpy(), **tol)
        np.testing.assert_allclose(g["db"], ref.bias.grad.numpy(), **tol)
        np.testing.assert_allclose(g["mean"], ref.running_mean.numpy(), **tol)
        np.testing.assert_allclose(g["var"], ref.running_var.numpy(), **tol)


def test_dryrun_multichip_world2(tmp_path):
    out = dryrun_multichip(2, "cpu", store_dir=str(tmp_path))
    assert out["allreduce"] == 24.0
    assert set(out["metrics"]) == {"s2", "s1", "vocoder", "ar"}
    assert out["tp"]["greedy_equal"] and out["tp"]["topk_equal"]


def _scalars(model_dir):
    with open(os.path.join(model_dir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f if '"loss/total"' in line]


def test_denoiser_cli_world2_equals_world1_at_the_global_batch(tmp_path):
    data = str(tmp_path / "data")
    _write_wavs(data)

    def argv(model, batch):
        return ["--data_dir", data, "--batch_size", str(batch), "--seg", "2000",
                "--dense_channel", "8", "--steps_per_epoch", "1", "--epochs",
                "1", "--eval_interval", "100", "--log_interval", "1",
                "--device", "cpu", "--logs_dir", str(tmp_path / "logs"),
                "-m", model]

    one = train_denoiser.main(argv("one", 2)).model.state_dict()
    two = spawn(ranks.cli_rank, 2, (free_port(), "megatts2_hierspeechpp_torch."
                                    "cli.train_denoiser", argv("two", 1), "model"),
                store_dir=str(tmp_path), init_group=False)
    for k, v in two[0].items():
        np.testing.assert_array_equal(v, two[1][k], err_msg=k)
    lr = 5e-4   # the CLI's default
    for k, v in one.items():
        if k.endswith(("running_mean", "running_var")):
            assert _rel_l2(two[0][k], v.numpy()) <= 1e-4, k
        elif v.is_floating_point():
            # Adam's first step moves an entry by about lr whatever the sign
            # of a gradient at rounding level (the biases before a norm)
            assert np.abs(two[0][k] - v.numpy()).max() <= 2 * lr * 1.001, k
    s1, s2 = (_scalars(str(tmp_path / "logs" / m)) for m in ("one", "two"))
    assert [r["step"] for r in s1] == [r["step"] for r in s2] == [1]
    assert os.listdir(tmp_path / "logs" / "two" / "ckpt") == ["step_00000001"]
    for a, b in zip(s1, s2):
        for k, v in a.items():
            if k.startswith("loss/"):
                np.testing.assert_allclose(b[k], v, rtol=1e-4, err_msg=k)
