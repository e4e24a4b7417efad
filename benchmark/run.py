#!/usr/bin/env python3
"""Run one benchmark cell once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``benchmark/``
and the measured package ``vision_semantic_segmentation_tpu_torch``.

The cell's entry in ``BENCHMARK.json`` names a configuration (its file under
``benchmark/configs/``) and a traffic mix (``benchmark/traffic/<traffic>.json``,
which names its driver, ``benchmark/drivers/<driver>.py``); every per-layer
metric is read by ``benchmark/metrics/<metric>.py``.  All are found by name,
so a cell, a configuration or a metric is added by adding files.

A run: set-up (weights and inputs made from ``--seed`` on the card, warm-up
of the cell's own shapes; ``setup_s`` is process start to the end of it),
then the measured window of ``--seconds``, then the check of what the window
produced against the plain reference (``benchmark/reference/``), after
``memory_peak_bytes`` is read and the program's state freed.  With
``--trace 1`` a short steady part of the window runs under
``torch.profiler`` and the line carries the per-layer metrics; with
``--trace 0`` the end-to-end ones.  The numbers compared are printed with
their limits as the last lines on standard error and under ``limits``, the
last key of the result; the result is the last line on standard output.

Exit codes: 0 after a result line (``correct`` may be false); 2 without a
card (or fewer than the cell asks for); 3 when a module of JAX or of the JAX
package is loaded after the window; 1 on any other error.  ``--control``
puts the reference computed one precision lower in the program's place for
the check (the control of the limits, which must come out not correct).

The configuration's ``network.reference`` names its reference network,
``benchmark/reference/<name>.py`` (``run.reference``), which the drivers and
the FLOP count use.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "vision_semantic_segmentation_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def load_file_module(name: str, path: Path):
    """A module from a file, under ``name`` (its package resolves relative imports)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reference(root: Path, net: dict):
    """The reference module that a configuration's ``network.reference``
    names: ``benchmark/reference/<name>.py`` under ``root`` (its contract is
    in ``benchmark/reference/__init__.py``).  There is no default."""
    name = net.get("reference")
    if not isinstance(name, str) or not name.isidentifier():
        raise ValueError(f"network.reference {name!r} names no reference module: it is "
                         f"the <name> of {root / 'benchmark' / 'reference'}/<name>.py")
    path = root / "benchmark" / "reference" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"network.reference {name!r}: no file {path}")
    return load_file_module(f"benchmark.reference.{name}", path)


class Run:
    """What a driver and a metric reader see of one run."""

    def __init__(self, root: Path, bench: dict, cell: dict, seed: int, seconds: float,
                 trace: bool, device: str, control: bool):
        from benchmark.core.trace import DeviceTrace, Spans

        self.root = root
        self.bench = bench
        self.cell = cell
        self.config_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
        self.config = json.loads((root / self.config_entry["file"]).read_text())
        self.reference = load_reference(root, self.config["network"])
        self.traffic = json.loads(
            (root / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.control = control
        self.spans = Spans(traced=self.trace)
        self.out_dir = root / "build" / "bench" / cell["name"]
        self.dtrace = DeviceTrace(self.out_dir) if self.trace and device == "cuda" else None
        self.window: Dict[str, object] = {}

    # -- the traced part of the window: units [skip, skip + units) -------------
    def trace_tick(self, unit: int, launches=None) -> None:
        """Called by a driver at the start of each unit of work (a window of
        frames, a training step) and once after the last."""
        if self.dtrace is None:
            return
        t = self.traffic.get("trace", {"skip": 2, "units": 2})
        if unit == t["skip"] and self.dtrace.prof is None:
            self.dtrace.units = int(t["units"])
            self.dtrace.start(launches)
        elif unit == t["skip"] + t["units"] and self.dtrace.active:
            self.dtrace.stop(launches)

    def finish_trace(self, launches=None) -> None:
        """Called by a driver once its window has closed.  A trace the window
        cut short counts no units: its work is not known."""
        if self.dtrace is not None and self.dtrace.active:
            self.dtrace.stop(launches)
            self.dtrace.units = 0


def cell_metrics(bench: dict, cell: str, kind: str) -> List[dict]:
    """The ``kind`` ('end_to_end' or 'per_layer') metrics this cell reports."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="check the reference one precision lower in the program's place")
    return p.parse_args(argv)


def main(argv=None, root: Optional[Path] = None, device: str = "cuda") -> int:
    args = parse(argv)
    root = Path(root) if root is not None else Path.cwd()
    # caches of the program and its libraries: fixed directories in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton_cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    bench_path = root / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in {bench_path}", file=sys.stderr)
        return 1
    cell = cells[args.workload]

    import torch

    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); {have} available",
                  file=sys.stderr)
            return 2
    run = Run(root, bench, cell, args.seed, args.seconds, bool(args.trace), device, args.control)
    driver_name = run.traffic["driver"]
    drv = load_file_module(f"benchmark.drivers.{driver_name}",
                           root / "benchmark" / "drivers" / f"{driver_name}.py")
    driver = drv.Driver(run)

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    driver.setup()
    setup_s = time.perf_counter() - T_START
    run.window = driver.window()
    if run.dtrace is not None:
        run.dtrace.collect()
    loaded = forbidden_modules()
    if loaded:
        print(f"modules of JAX or the JAX package loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0
    driver.release()
    checks = driver.check()
    attempted = int(run.window["attempted"])
    failed = int(run.window["failed"])
    correct = failed == 0 and all(value <= limit for _, value, limit in checks)

    if args.trace:
        metrics = {}
        for m in cell_metrics(bench, cell["name"], "per_layer"):
            reader = load_file_module(f"benchmark.metrics.{m['name'].replace('.', '_')}",
                                      root / "benchmark" / "metrics" / f"{m['name']}.py")
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(run.window["end_to_end"], setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell_metrics(bench, cell["name"], "end_to_end")}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if run.dtrace is not None and run.dtrace.window_s > 0:
        dev["busy_s"] = run.dtrace.busy_s
        dev["window_s"] = run.dtrace.window_s
        result["breakdown"] = {"device_ops": run.dtrace.top_ops(),
                               "idle_gaps": run.dtrace.idle_gaps()}
    for line in run.window.get("notes", []):
        print(line, flush=True)
    result["limits"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    result["limits"]["failed"] = {"value": failed, "limit": 0}
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r} {'ok' if value <= limit else 'FAILED'}",
              file=sys.stderr)
    print(f"check failed {failed} limit 0 {'ok' if failed == 0 else 'FAILED'}", file=sys.stderr,
          flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
