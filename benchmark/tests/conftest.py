"""Tests of the benchmark harness.

    python -m pytest benchmark/tests -q                      # CPU, about 3 minutes
    python -m pytest benchmark/tests -q -m cuda               # on a machine with a card

Tests marked ``cuda`` need a card: they decide so inside the ``cuda_device``
fixture and skip without one.  CPU tests run the harness on a small copy of
the benchmark's files (``tiny_root``): the configurations' widths stay, the
frames are shrunk by ``image_scale``, the grid and the clouds are smaller.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def make_tiny_root(dst: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and the benchmark's data, drivers,
    readers and reference networks, shrunk to run on the CPU in seconds."""
    (dst / "benchmark").mkdir(parents=True)
    for sub in ("configs", "traffic", "metrics", "drivers", "reference"):
        shutil.copytree(REPO / "benchmark" / sub, dst / "benchmark" / sub)
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    for p in (dst / "benchmark" / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        if "input" in c:
            c["input"]["image_scale"] = 0.05  # 72 x 96 network input
        c["map"] = dict(c.get("map", {}), boundary=[[100, 140], [800, 840]], point_bucket=4096)
        if "train" in c:
            c["train"].update(batch_size=2, crop=65, augmentation=c["train"]["augmentation"]
                              .replace("513", "65"))
        p.write_text(json.dumps(c))
    for p in (dst / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        if "frames" in t:
            t["frames"].update(pool=4, start_m=5.0)
            t["window"] = 2
        if "batches" in t:
            t["batches"].update(pool=3, blob_px=8)
            t.update(warmup_steps=1, probe_units=[0, 1], trace={"skip": 0, "units": 1})
        p.write_text(json.dumps(t))
    return dst


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_tiny_root(tmp_path / "root")


def run_cell(root: Path, cell: str, seed: int = 2147483701, seconds: float = 1.0,
             extra=()):
    """Drive one run of the harness on the CPU; the result line as a dict."""
    import contextlib
    import io

    from benchmark import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", "0", *extra], root=root, device="cpu")
    assert rc == 0, out.getvalue()[-2000:]
    return json.loads(out.getvalue().strip().splitlines()[-1])
