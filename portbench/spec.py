"""Everything the benchmark runs, found by name from ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; each lives in a file of
its own: ``configs/<name>.json`` (as the configuration entry's ``file``
says), ``traffic/<mix>.json``, ``limits/<cell>.json`` (the limits of the
numbers that decide ``correct``), ``metrics/<metric>.py`` (a reader with
``read(run) -> float | None``; where there is none, the family's
``metrics/<part before the first dot>.py``: ``mfu.train`` and
``mfu.prefill`` share ``mfu.py``), ``loops/<kind>.py`` (the general loop
of a kind of mix: set-up, window, outputs, check) and
``reference/<name>.py`` (a configuration's plain reference, named by its
``reference`` key). Adding a cell, a mix or a metric adds files and
entries; no file here lists them.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent


class Spec:
    def __init__(self, root: Path = HERE.parent, here: Path = HERE):
        self.root, self.here = Path(root), Path(here)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self._mods: Dict[Path, ModuleType] = {}

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, mix: str) -> dict:
        return json.loads((self.here / "traffic" / f"{mix}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.here / "limits" / f"{cell}.json").read_text())

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The metrics a cell reports: its end-to-end ones untraced, its
        per-layer ones traced (those whose ``workloads`` list it, or that
        have none)."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def module(self, kind: str, name: str) -> ModuleType:
        """``<kind>/<name>.py`` under the benchmark's folder, loaded once."""
        path = self.here / kind / f"{name}.py"
        if path not in self._mods:
            modname = f"portbench_{kind}_{name}".replace(".", "_").replace(
                "-", "_")
            spec = importlib.util.spec_from_file_location(modname, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[modname] = mod
            spec.loader.exec_module(mod)
            self._mods[path] = mod
        return self._mods[path]

    def reader(self, metric: str) -> ModuleType:
        own = self.here / "metrics" / f"{metric}.py"
        return self.module("metrics", metric if own.exists()
                           else metric.split(".")[0])

    def loop(self, kind: str) -> ModuleType:
        return self.module("loops", kind)

    def reference(self, conf: dict) -> ModuleType:
        return self.module("reference", conf["reference"])
