"""Fixtures of the harness tests: a tiny checkout and CPU runs in it."""

import pytest

from vtbench.tests import tiny


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("checkout")))


@pytest.fixture
def on_cpu(monkeypatch):
    """The harness on the CPU with the tiny models, for this test only."""
    import torch

    from videotransformer_tpu_torch.training import trainer as trainer_mod
    from vtbench import devices

    monkeypatch.setattr(devices, "card", lambda rank=0: torch.device("cpu"))
    monkeypatch.setattr(devices, "require", lambda chips: None)
    monkeypatch.setattr(trainer_mod, "build_model", tiny.tiny_model)
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def run_cell(root, cell, seed=3000000041, seconds=2.0, trace=0):
    """The result line (a dict) of one CPU run of ``cell`` through the
    harness's entry, and its exit code."""
    import contextlib
    import io
    import json

    from vtbench import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace)], root=root)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 else None), lines
