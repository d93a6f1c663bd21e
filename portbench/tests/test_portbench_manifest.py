"""BENCHMARK.json against its contract, the files it names, and the
imports of a run: no JAX anywhere, nothing of the port in the reference."""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "megatts2_hierspeechpp_tpu"}
CELLS = {w["name"]: w for w in BENCH["workloads"]}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _cells_of(metric):
    return metric.get("workloads", list(CELLS))


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units():
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + METRICS]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]), w
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in _cells_of(m):
            assert cell in CELLS
            assert cell in _cells_of(e2e[m["moves"]]), (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for cell in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"] if cell in _cells_of(m)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert any(cell in _cells_of(m) for m in BENCH["per_layer"]), cell


def test_every_configuration_has_a_cell_and_its_files():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (ROOT / "portbench" / "counts" / f"{c['name']}.py").exists()
    for w in BENCH["workloads"]:
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").exists()


def test_every_metric_has_a_reader():
    for m in METRICS:
        stems = (m["name"], m["name"].rsplit(".", 1)[0])
        assert any((ROOT / "portbench" / "metrics" / f"{s}.py").exists()
                   for s in stems), m["name"]


def test_paths_and_command():
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_a_run_imports_no_jax():
    mods = _modules_after(
        "import sys; sys.path.insert(0, '.')\n"
        "import portbench.run, portbench.harness.cell, portbench.harness.program\n"
        "import megatts2_hierspeechpp_torch.infer.server\n"
        "import megatts2_hierspeechpp_torch.models.vocoder, megatts2_hierspeechpp_torch.models.plm")
    assert not mods & FORBIDDEN
    assert "megatts2_hierspeechpp_torch" in mods


def test_the_reference_imports_nothing_of_the_port():
    mods = _modules_after(
        "import sys; sys.path.insert(0, '.')\n"
        "import portbench.reference.tts, portbench.reference.precision")
    assert not mods & (FORBIDDEN | {"megatts2_hierspeechpp_torch"})


def test_run_checks_modules_after_the_window():
    sys.path.insert(0, str(ROOT))
    from portbench import run
    src = (ROOT / "portbench" / "run.py").read_text()
    assert src.index("found = forbidden_modules()") > src.index("cell_lib.run(")
    assert set(run.FORBIDDEN) == FORBIDDEN


@pytest.mark.cuda
def test_cuda_visible_on_the_card():
    """Run on the card (python -m pytest -m cuda portbench/tests): the
    harness's device check passes there."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert torch.cuda.device_count() >= max(w["chips"] for w in BENCH["workloads"])
