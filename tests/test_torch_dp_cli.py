"""The sampler CLIs at world 2 on the CPU: cli/train_s2 and cli/train_s1
under torchrun's variables (two gloo ranks on a free port), on a tiny
corpus of cli/make_synth_corpus at tests/test_torch_train_s2_cli.py's cut
depths, batch 2 a rank.

Each rank takes its share of the sampler's batches, the batches padded to
the largest of either rank's; k-means fits on both ranks' first batches
and rank 0's codebooks are broadcast. After one epoch both ranks hold
bitwise the same TTV (codebooks included), rank 0 alone wrote one scalar
record a step and the checkpoint; a second run on the same directory
resumes on both ranks and ends equal on both; s1 at world 2 from that
checkpoint ends with both ranks' PLMs equal."""
import json
import os
import shutil

import numpy as np
import pytest

from megatts2_hierspeechpp_torch.cli import make_synth_corpus
from megatts2_hierspeechpp_torch.parallel.dryrun import spawn
from tests import torch_dp_ranks as ranks
from tests.test_torch_dp_mesh import free_port
from tests.test_torch_train_s2_cli import small_config


@pytest.fixture(autouse=True)
def _remove_run_dirs(tmp_path):
    """Each test's run directories (checkpoints at published widths) are
    removed once its asserts have run: a whole Tier-1 run would otherwise
    fill a small /tmp."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dpcorpus"))
    make_synth_corpus.make_corpus(d, n=8, seed=3, holdout=2)
    yield d
    shutil.rmtree(d, ignore_errors=True)


def run(tmp_path, module, argv, attr):
    return spawn(ranks.cli_rank, 2, (free_port(), module, argv, attr),
                 store_dir=str(tmp_path), init_group=False)


def assert_equal(a, b):
    assert a.keys() == b.keys()
    for k, v in a.items():
        np.testing.assert_array_equal(v, b[k], err_msg=k)


def records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_s2_and_s1_clis_at_world_2(corpus, tmp_path):
    logs = str(tmp_path / "logs")
    s2 = "megatts2_hierspeechpp_torch.cli.train_s2"
    one = small_config(tmp_path / "e1.json", corpus)
    two = small_config(tmp_path / "e2.json", corpus, epochs=2)
    argv = ["--logs_dir", logs, "-m", "s2", "--device", "cpu", "-c"]
    a, b = run(tmp_path, s2, argv + [one], "ttv")
    assert_equal(a, b)
    assert any(k.startswith("quantizer.") for k in a)
    recs = [r for r in records(os.path.join(logs, "s2", "scalars.jsonl"))
            if "loss/g/total" in r]
    steps = [r["step"] for r in recs]
    assert steps == list(range(1, len(steps) + 1)) and steps
    assert f"step_{steps[-1]:08d}" in os.listdir(os.path.join(logs, "s2", "ckpt"))

    c, d = run(tmp_path, s2, argv + [two], "ttv")   # resumed on both ranks
    assert_equal(c, d)
    more = [r["step"] for r in records(os.path.join(logs, "s2", "scalars.jsonl"))
            if "loss/g/total" in r]
    assert more == list(range(1, 2 * len(steps) + 1))
    assert any(not np.array_equal(c[k], a[k]) for k in a)

    s1 = "megatts2_hierspeechpp_torch.cli.train_s1"
    e, f = run(tmp_path, s1, ["--logs_dir", logs, "-m", "s1", "--device", "cpu",
                              "-c", one, "--s2_ckpt", os.path.join(logs, "s2", "ckpt")],
               "plm")
    assert_equal(e, f)
