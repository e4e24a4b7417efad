"""The harness finds a cell, a configuration, a traffic mix and a per-layer
metric by name: dropping files into a copy (and naming them in its
``BENCHMARK.json``) adds them, with no other file edited."""
from __future__ import annotations

import json
import shutil

from benchmark.tests.conftest import run_cell


def test_dropped_files_are_found(tiny_root):
    b = tiny_root / "benchmark"
    conf = json.loads((b / "configs/deeplabv3p-rx50-os8-serve.json").read_text())
    conf["name"] = "dropped-config"
    (b / "configs/dropped-config.json").write_text(json.dumps(conf))
    shutil.copy(b / "traffic/replay.json", b / "traffic/dropped-traffic.json")
    (b / "metrics/stage_count.dropped.py").write_text(
        "def read(run):\n    return len(run.spans.times['stage'])\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dropped-config", "source": "https://example.org/a",
                             "file": "benchmark/configs/dropped-config.json", "reduced": [],
                             "why": "a dropped configuration"})
    bench["workloads"].append({"name": "dropped.cell", "config": "dropped-config",
                               "traffic": "dropped-traffic", "chips": 1, "why": "dropped"})
    bench["end_to_end"][0]["workloads"].append("dropped.cell")
    bench["per_layer"].append({"name": "stage_count.dropped", "unit": "count",
                               "better": "higher", "source": "host_clock", "layer": "staging",
                               "moves": "frames_per_s", "workloads": ["dropped.cell"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    e2e = run_cell(tiny_root, "dropped.cell")
    assert set(e2e["metrics"]) == {"frames_per_s", "setup_s"} and e2e["correct"]
    traced = run_cell(tiny_root, "dropped.cell", extra=["--trace", "1"])
    assert traced["metrics"]["stage_count.dropped"]["value"] >= 1
