"""The port's ETL-fed examples on the CPU: ``quickstart`` against the JAX
package's ``examples/quickstart.py`` (the same prints for the same seeded
plant, facts within the transform's 1e-5), and ``train_lm`` at
``lm_small`` width for a few steps (the loss falls; a resumed run restores
the model, the optimizer and the corpus bitwise and keeps the listener
offsets, extracting no record twice)."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro_torch.examples import quickstart, train_lm
from repro_torch.models.param import tree_leaves
from repro_torch.train.checkpoint import CheckpointManager, flatten

ROOT = Path(__file__).resolve().parents[1]


def _reference_quickstart(monkeypatch):
    """The JAX package's example, run as it is; returns its pipeline."""
    spec = importlib.util.spec_from_file_location(
        "reference_quickstart", ROOT / "examples" / "quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    made = []

    class Recorded(ref_core.DODETLPipeline):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(mod, "DODETLPipeline", Recorded)
    mod.main()
    return made[0]


def _lines(text):
    """The printed lines, the cache bootstrap's wall time left out."""
    return [l for l in text.splitlines() if not l.startswith("cache ")]


def test_quickstart_matches_reference_on_cpu(monkeypatch, capsys):
    pipe = quickstart.main(["--device", "cpu"])
    ours = capsys.readouterr().out
    ref = _reference_quickstart(monkeypatch)
    theirs = capsys.readouterr().out
    assert _lines(ours) == _lines(theirs) and len(_lines(ours)) == 7
    got = pipe.warehouse.canonical_fact_table()
    want = ref.warehouse.canonical_fact_table()
    assert got.shape == want.shape == (5000, 10)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_quickstart_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quickstart.main([])


def test_train_lm_trains_and_resumes_on_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    first = train_lm.main(["--device", "cpu", "--steps", "3",
                           "--ckpt-every", "3", "--ckpt", ck])
    assert first["losses"][-1] < first["losses"][0], first["losses"]
    assert first["extracted"] == 60_000
    # the checkpoint holds the final state, bitwise
    tree = {"params": first["params"], "opt": first["opt"], "corpus": None}
    step, got, extra = CheckpointManager(ck).restore_latest(tree)
    assert step == 3 and extra["stream"] == first["stream"]
    saved = flatten(got)[0]
    for a, b in zip(saved, flatten(tree)[0]):
        if b is not None:
            assert a.dtype == b.dtype and torch.equal(a, b)
    corpus = got["corpus"]
    assert corpus.dtype == torch.float32 and corpus.shape[1] == 10

    again = train_lm.main(["--device", "cpu", "--steps", "1",
                           "--ckpt-every", "100", "--ckpt", ck,
                           "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out
    assert again["resumed_from"] == 3 and again["first_step"] == 4
    assert again["extracted"] == 0              # no record extracted twice
    assert again["stream"] == first["stream"]
    assert len(tree_leaves(again["params"])) == len(
        tree_leaves(first["params"]))
    assert np.isfinite(again["losses"]).all()
