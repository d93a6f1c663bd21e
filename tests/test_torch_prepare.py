"""The port's AR data front end against the JAX CLIs on the CPU:

  - cli/prepare_text.main: the `2-name2text-{i}.txt` table byte-equal to the
    JAX CLI's (zh and en lines, a 3-column line both skip, both shards of
    --shard i/2), and with a tiny BertForMaskedLM (skipped when
    `transformers` is absent) the `3-bert` sidecars within 1e-6; with
    --bert_ckpt and no --device it raises without CUDA;
  - TTVModel.extract_latent against JAX's, exactly;
  - cli/prepare_semantic.main against the JAX CLI on a reference-layout TTV
    .pth at the published widths (a seeded port TTVModel's state_dict as
    {"model": sd}), which both CLIs load: the codes and the TSV equal;
  - the name hazard: a `prepare_text` row names the utterance `utt0000.wav`
    (the wav's basename), `prepare_semantic` names it `utt0000` (the
    sidecar's stem), so their tables never join in Text2SemanticDataset.
    This is the JAX package's behaviour, and the port keeps it."""
import os
import sys

import numpy as np
import pytest
import torch

from megatts2_hierspeechpp_torch.ar.dataset import Text2SemanticDataset
from megatts2_hierspeechpp_torch.cli import prepare_semantic as tps
from megatts2_hierspeechpp_torch.cli import prepare_text as tpt
from megatts2_hierspeechpp_torch.data import text as ttext
from megatts2_hierspeechpp_torch.models.ttv import TTVModel
from megatts2_hierspeechpp_tpu.ar.dataset import Text2SemanticDataset as JDataset
from megatts2_hierspeechpp_tpu.cli import prepare_semantic as jps
from megatts2_hierspeechpp_tpu.cli import prepare_text as jpt
from megatts2_hierspeechpp_tpu.models import ttv as jttv
from megatts2_hierspeechpp_tpu.models.convert import convert_ttv
from tests.test_torch_kernels import few_torch_threads  # noqa: F401

LINES = [
    "/data/a/utt1.wav|spk0|zh|sil zh ong1 #1 g uo2 #4 。 eos|中文中文",
    "/data/a/utt2.wav|spk1|en|sil HH AH0 L OW1 #4 。 eos",
    "/data/a/utt3.wav|spk1|zh",                      # 3 columns: skipped
    "/data/b/utt4.wav|spk2|zh|sil n i3 h ao3 sp sh ir4 j ie4 eos|你好世界",
]


def run_jax(main, monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", [main.__module__, *argv])
    main()


@pytest.mark.parametrize("shard", ["0/1", "0/2", "1/2"])
def test_prepare_text_table_byte_equal(tmp_path, monkeypatch, shard):
    filelist = tmp_path / "list.txt"
    filelist.write_text("\n".join(LINES) + "\n", encoding="utf-8")
    i = shard.split("/")[0]
    args = ["--filelist", str(filelist), "--shard", shard]
    run_jax(jpt.main, monkeypatch, [*args, "--opt_dir", str(tmp_path / "jax")])
    tpt.main([*args, "--opt_dir", str(tmp_path / "port")])
    want = (tmp_path / "jax" / f"2-name2text-{i}.txt").read_bytes()
    assert (tmp_path / "port" / f"2-name2text-{i}.txt").read_bytes() == want
    assert b"utt3.wav" not in want


def test_prepare_text_bert_sidecars(tmp_path, monkeypatch):
    pytest.importorskip("transformers")
    from tests.test_prepare_datasets import _tiny_bert_dir

    bert = _tiny_bert_dir(tmp_path)
    filelist = tmp_path / "list.txt"
    filelist.write_text(LINES[0] + "\n" + LINES[1] + "\n", encoding="utf-8")
    args = ["--filelist", str(filelist), "--bert_ckpt", bert]
    run_jax(jpt.main, monkeypatch, [*args, "--opt_dir", str(tmp_path / "jax")])
    tpt.main([*args, "--opt_dir", str(tmp_path / "port"), "--device", "cpu"])
    for side in ("jax", "port"):
        assert sorted(os.listdir(tmp_path / side / "3-bert")) == ["utt1.wav.npy"]
    want = np.load(tmp_path / "jax" / "3-bert" / "utt1.wav.npy")
    got = np.load(tmp_path / "port" / "3-bert" / "utt1.wav.npy")
    assert got.shape == want.shape == (6, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert ((tmp_path / "port" / "2-name2text-0.txt").read_bytes()
            == (tmp_path / "jax" / "2-name2text-0.txt").read_bytes())


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only case")
def test_prepare_text_bert_raises_without_cuda(tmp_path):
    """--device defaults to cuda: with --bert_ckpt and without CUDA the CLI
    raises before it loads the model, it does not move to the CPU."""
    filelist = tmp_path / "list.txt"
    filelist.write_text(LINES[0] + "\n", encoding="utf-8")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpt.main(["--filelist", str(filelist), "--opt_dir", str(tmp_path),
                  "--bert_ckpt", str(tmp_path / "bert")])


@pytest.fixture(scope="module")
def ttv_file(tmp_path_factory):
    """A reference-layout TTV .pth at the published widths."""
    d = tmp_path_factory.mktemp("ttv")
    ttv = TTVModel(n_vocab=ttext.N_VOCAB, n_tone=ttext.N_TONE,
                   n_language=ttext.N_LANGUAGE, seed=21, device="cpu")
    path = str(d / "ttv.pth")
    torch.save({"model": ttv.state_dict(), "iteration": 1}, path)
    yield path, ttv
    os.remove(path)


def test_extract_latent_matches_jax(ttv_file):
    path, ttv = ttv_file
    jm = jttv.TTVModel(n_vocab=ttext.N_VOCAB, n_tone=ttext.N_TONE,
                       n_language=ttext.N_LANGUAGE)
    variables = convert_ttv(torch.load(path, weights_only=True)["model"])
    x = np.random.default_rng(3).standard_normal((2, 13, 20)).astype(np.float32)
    want = np.asarray(jm.apply(variables, x, method=jttv.TTVModel.extract_latent))
    got = ttv.extract_latent(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1, 13) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def write_mels(d):
    rng = np.random.default_rng(4)
    (d / "sub").mkdir(parents=True)
    mels = {d / "utt0000.hmel.npy": (83, 80), d / "sub" / "utt0001.hmel.npy": (80, 120),
            d / "utt0002.hmel.npy": (97, 80)}
    for p, shape in mels.items():
        np.save(p, (rng.standard_normal(shape) - 4.0).astype(np.float32))


def test_prepare_semantic_matches_jax_cli(ttv_file, tmp_path, monkeypatch):
    path, _ = ttv_file
    out = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        write_mels(d)
        args = ["--mel_dir", str(d), "--s2_ckpt", path, "--tsv_out",
                str(d / "6-name2semantic.tsv")]
        if side == "jax":
            run_jax(jps.main, monkeypatch, args)
        else:
            tps.main([*args, "--device", "cpu"])
        out[side] = d
    assert ((out["port"] / "6-name2semantic.tsv").read_text()
            == (out["jax"] / "6-name2semantic.tsv").read_text())
    for rel in ("utt0000", "sub/utt0001", "utt0002"):
        want = np.load(out["jax"] / f"{rel}.semantic.npy")
        got = np.load(out["port"] / f"{rel}.semantic.npy")
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert np.load(out["port"] / "sub/utt0001.semantic.npy").shape == (15,)
    with pytest.raises(SystemExit):
        tps.main(["--mel_dir", str(tmp_path), "--s2_ckpt", str(tmp_path),
                  "--device", "cpu"])


def test_prep_names_do_not_join(ttv_file, tmp_path, monkeypatch):
    """JAX's behaviour, kept: prepare_text names the row utt0000.wav,
    prepare_semantic names it utt0000, so the AR dataset of the two tables
    is empty on both sides."""
    path, _ = ttv_file
    filelist = tmp_path / "list.txt"
    filelist.write_text(f"{tmp_path}/utt0000.wav|spk0|zh|sil zh ong1 g uo2 eos\n",
                        encoding="utf-8")
    np.save(tmp_path / "utt0000.hmel.npy",
            np.random.default_rng(5).standard_normal((96, 80)).astype(np.float32))
    sizes = {}
    for side, ds in (("jax", JDataset), ("port", Text2SemanticDataset)):
        opt = tmp_path / side
        tsv = str(tmp_path / f"{side}.tsv")
        if side == "jax":
            run_jax(jpt.main, monkeypatch, ["--filelist", str(filelist),
                                            "--opt_dir", str(opt)])
            run_jax(jps.main, monkeypatch, ["--mel_dir", str(tmp_path),
                                            "--s2_ckpt", path, "--tsv_out", tsv])
        else:
            tpt.main(["--filelist", str(filelist), "--opt_dir", str(opt)])
            tps.main(["--mel_dir", str(tmp_path), "--s2_ckpt", path,
                      "--tsv_out", tsv, "--device", "cpu"])
        text_name = (opt / "2-name2text-0.txt").read_text().split("\t")[0]
        sem_name = open(tsv).read().split("\t")[0]
        assert (text_name, sem_name) == ("utt0000.wav", "utt0000")
        sizes[side] = len(ds(str(opt / "2-name2text-0.txt"), tsv, ttext.SYMBOL_TO_ID,
                             min_ps_ratio=0.0, max_ps_ratio=1e9))
    assert sizes == {"jax": 0, "port": 0}


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only case")
def test_prepare_semantic_raises_without_cuda(tmp_path):
    """--device defaults to cuda: without CUDA the CLI raises before it
    reads anything, it does not move to the CPU."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tps.main(["--mel_dir", str(tmp_path), "--s2_ckpt", "ttv.pth"])
