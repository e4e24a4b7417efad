"""The harness finds a cell, a configuration, a traffic mix, a per-layer
metric and a reference network by name: dropping files into a copy (and
naming them in its ``BENCHMARK.json``) adds them, with no other file
edited."""
from __future__ import annotations

import json
import re
import shutil
from types import SimpleNamespace

import pytest

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


def _drop_family_cell(root, reference, cell="family.cell"):
    """A configuration that names ``reference`` and a cell of it on the
    replay traffic, named in the copy's ``BENCHMARK.json``."""
    b = root / "benchmark"
    conf = json.loads((b / "configs/deeplabv3p-rx50-os8-serve.json").read_text())
    conf["name"] = "family-config"
    conf["network"]["reference"] = reference
    (b / "configs/family-config.json").write_text(json.dumps(conf))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "family-config", "source": "https://example.org/b",
                             "file": "benchmark/configs/family-config.json", "reduced": [],
                             "why": "a configuration of a dropped reference network"})
    bench["workloads"].append({"name": cell, "config": "family-config", "traffic": "replay",
                               "chips": 1, "why": "dropped"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("frames_per_s", "mfu_pct.fps"):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return conf


def test_dropped_reference_network_is_found(tiny_root, monkeypatch):
    """A reference module (``deeplab.py`` under another name) and a
    configuration that names it run through the harness, the FLOP count
    and the checks with it.  The CPU has no device trace: a stand-in of one
    traced frame a second lets ``mfu_pct.fps`` read."""
    from benchmark.core import readings
    from benchmark.counts.flops import forward_flops
    from benchmark.counts.kernels import H100_BF16_FLOPS
    from benchmark.run import load_reference

    b = tiny_root / "benchmark"
    shutil.copy(b / "reference/deeplab.py", b / "reference/dropped_net.py")
    conf = _drop_family_cell(tiny_root, "dropped_net")

    e2e = run_cell(tiny_root, "family.cell")
    assert set(e2e["metrics"]) == {"frames_per_s", "setup_s"} and e2e["correct"]
    monkeypatch.setattr(readings, "traced", lambda run: SimpleNamespace(window_s=1.0))
    monkeypatch.setattr(readings, "traced_work", lambda run: 1.0)
    traced = run_cell(tiny_root, "family.cell", extra=["--trace", "1"])
    assert traced["correct"]
    dropped = load_reference(tiny_root, conf["network"])
    assert dropped.__file__ == str(b / "reference/dropped_net.py")
    flops = forward_flops(dropped, conf["network"], 1440, 1920)
    assert flops == 2369179275264  # the count of the network it copies
    assert traced["metrics"] == {"mfu_pct.fps": {"value": 100.0 * flops / H100_BF16_FLOPS,
                                                 "unit": "%"}}


@pytest.mark.parametrize("reference", [None, "no_such_net"])
def test_missing_reference_stops_the_run(tiny_root, reference):
    """No default: a configuration without ``network.reference``, or naming
    a module that is not there, stops the run before set-up, naming the
    file it looked for."""
    from benchmark import run

    conf = _drop_family_cell(tiny_root, reference)
    if reference is None:
        del conf["network"]["reference"]
        (tiny_root / "benchmark/configs/family-config.json").write_text(json.dumps(conf))
    looked_for = tiny_root / f"benchmark/reference/{reference or '<name>'}.py"
    with pytest.raises((FileNotFoundError, ValueError), match=re.escape(str(looked_for))):
        run.main(["--workload", "family.cell", "--seed", "5", "--seconds", "1"],
                 root=tiny_root, device="cpu")
