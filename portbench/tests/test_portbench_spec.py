"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs found by name, also for cells added as files alone."""
from __future__ import annotations

import json
import re

import pytest

from conftest import CELLS, HERE, ROOT

from portbench.spec import Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entries():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in BENCH[group]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for group in ("end_to_end", "per_layer"):
        for m in BENCH[group]:
            allowed = {"name", "unit", "better", "source", "workloads"} | (
                {"bound"} if group == "end_to_end" else
                {"layer", "moves"})
            assert set(m) <= allowed and set(m) >= allowed - {"workloads"}
            assert NAME.match(m["name"]) and m["name"] not in seen
            seen.add(m["name"])
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    spec = Spec(ROOT)
    for cell in BENCH["workloads"]:
        assert cell["chips"] == 1
        names = {m["name"] for m in spec.metrics(cell["name"], False)}
        assert "setup_s" in names and len(names) >= 2
        layer = spec.metrics(cell["name"], True)
        assert layer
        for m in layer:
            assert m["moves"] in names, (cell["name"], m["name"])
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in {
                x["name"] for x in spec.metrics(cell, False)}


def test_configs_files_and_reduced():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        for key in c["reduced"]:
            assert NAME.match(key) and key in conf
            assert not key.endswith(("_dim", "_rank", "_size"))


def test_every_file_found_by_name():
    spec = Spec(ROOT)
    for cell in BENCH["workloads"]:
        conf = spec.config(cell["config"])
        traffic = spec.traffic(cell["traffic"])
        assert spec.loop(traffic["kind"]).check
        assert spec.reference(conf).Dims.of(conf)
        lim = spec.limits(cell["name"])
        assert all(isinstance(v, float) and v > 0 for v in lim.values())
    for group in ("end_to_end", "per_layer"):
        for m in BENCH[group]:
            assert callable(spec.reader(m["name"]).read)


def test_cells_added_as_files_alone(tiny_root):
    """The tiny cells come as new files and new entries only: nothing of
    the copy of portbench/ is edited, and each is found by name."""
    spec = Spec(tiny_root, tiny_root / "portbench")
    for cell, (conf, mix, _) in CELLS.items():
        assert spec.cell(cell)["config"] == conf
        assert spec.config(conf)["name"] == conf
        assert spec.traffic(mix)["name"] == mix
        assert spec.limits(cell)
    for path in HERE.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts \
                and "tests" not in path.relative_to(HERE).parts:
            copy = tiny_root / "portbench" / path.relative_to(HERE)
            assert copy.read_bytes() == path.read_bytes()


def test_metric_added_as_a_file(tiny_root):
    (tiny_root / "portbench" / "metrics" / "tokens_per_request.py"
     ).write_text("def read(run):\n    return run.tokens / run.units\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "tokens_per_request", "unit": "tokens", "better": "higher",
        "source": "host_clock", "layer": "serve step and model",
        "moves": "prefill_tokens_per_s", "workloads": ["tiny-dense.prefill"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec(tiny_root, tiny_root / "portbench")
    names = [m["name"] for m in spec.metrics("tiny-dense.prefill", True)]
    assert "tokens_per_request" in names
    assert "tokens_per_request" not in [
        m["name"] for m in spec.metrics("internlm2-1.8b.prefill", True)]

    class Run:
        tokens, units = 128, 2
    assert spec.reader("tokens_per_request").read(Run) == 64


def test_unknown_names_raise():
    spec = Spec(ROOT)
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")
    with pytest.raises(KeyError):
        spec.config("no-such-config")
