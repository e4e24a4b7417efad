"""On the card, at each cell's own size: the control (the reference one
precision lower in the program's place) comes out not correct on three
seeds.  ``python -m pytest benchmark/tests -q -m cuda`` on a machine with a
card; about 4 minutes a cell."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.tests.conftest import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cuda_device, cell):
    for seed in (2147483801, 2147483802, 2147483803):
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                              str(seed), "--seconds", "5", "--trace", "0", "--control"],
                             capture_output=True, text=True, cwd=REPO, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"] is False, result["limits"]
