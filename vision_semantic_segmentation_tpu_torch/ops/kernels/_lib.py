"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and builds with ``nvcc``
into its own shared library under ``build/torch_kernels/`` at the repo root,
at first use (the build is never run at import: the package imports on
machines without ``nvcc``).  The library is loaded with ``ctypes``; every
pointer and the stream pass as ``c_void_p``.  A library's file name carries
a hash of its source and flags, so an edited source rebuilds and an
unchanged one is reused.  :func:`build_all` starts one ``nvcc`` per source,
all at once, and waits for them together.

A source may carry several C entry points, each its own
:class:`CudaKernel`; they share one library and one ``nvcc``.

The launching wrappers of K2, K3 and K4 are operators of the
``torch.library`` namespace ``vss_torch`` (:data:`OPS`, defined by their
modules with a CUDA impl that launches the kernel, a CPU impl that runs the
plain version and a fake impl that gives the output's shape and strides),
so ``torch.export`` keeps each launch as one node of a graph.  The
low-level ``Library`` API adds a few microseconds a call and imports
nothing more.

Each :class:`CudaKernel` keeps ``launches``, the number of kernel launches
its wrapper made.  ``plain_on_cuda`` is a test hook: while it is set (see
:func:`plain_versions`), the wrapper runs its plain PyTorch version on a CUDA
tensor instead of the kernel, so a whole run can be compared against the
plain path.  Nothing on the main path sets it.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_REGISTRY: List["CudaKernel"] = []
OPS = torch.library.Library("vss_torch", "FRAGMENT")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


class CudaKernel:
    """One ``csrc`` source, its C entry point and its launch count."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: Sequence):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.plain_on_cuda = False
        self.build_log = ""
        self._fn = None
        _REGISTRY.append(self)

    @property
    def source_path(self) -> Path:
        return CSRC_DIR / self.source

    def library_path(self) -> Path:
        digest = hashlib.sha1()
        digest.update(self.source_path.read_bytes())
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            digest.update(header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source_path.stem}-{digest.hexdigest()[:16]}.so"

    def _load(self):
        if self._fn is None:
            build_all([self])
            lib = ctypes.CDLL(str(self.library_path()))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Call the C entry point and count the launch.

        The launch goes to the current stream of its tensors' device (the
        device of the :func:`ptr` arguments, which must agree), with that
        device current: a mesh over several cards launches each band's
        kernel on its own card.  The C function returns the ``cudaError_t``
        of its launch; a refused launch raises here (``torch.cuda.
        synchronize`` would not report it).
        """
        devices = {a.device for a in args if isinstance(a, DevicePtr)}
        if len(devices) != 1:
            raise ValueError(f"{self.name}: tensors on {sorted(map(str, devices))}, not one card")
        (device,) = devices
        fn = self._load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device)
            err = fn(*args, ctypes.c_void_p(stream.cuda_stream))
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.symbol} failed: cudaError_t {err}")
        self.launches += 1


def kernels() -> List[CudaKernel]:
    return list(_REGISTRY)


def build_all(which: Optional[Iterable[CudaKernel]] = None) -> Dict[str, float]:
    """Build every missing library, one ``nvcc`` per source, all in parallel.

    Returns seconds per kernel name (0.0 for a library already built).
    Raises with the compiler's output when a build fails.
    """
    todo = list(which) if which is not None else kernels()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}  # library path -> (kernels sharing it, nvcc, tmp file, start)
    seconds: Dict[str, float] = {}
    for k in todo:
        out = k.library_path()
        if out.exists():
            seconds[k.name] = 0.0
        elif out in started:  # another entry point of the same source
            started[out][0].append(k)
        else:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(k.source_path)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            started[out] = ([k], proc, tmp, time.perf_counter())
    failures = []
    for out, (sharing, proc, tmp, t0) in started.items():
        log, _ = proc.communicate()
        for k in sharing:
            seconds[k.name] = time.perf_counter() - t0
            k.build_log = log
        if proc.returncode != 0:
            failures.append(f"{sharing[0].source}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


@contextlib.contextmanager
def plain_versions() -> Iterator[None]:
    """Run every wrapper's plain PyTorch version, on CUDA tensors too."""
    saved = [(k, k.plain_on_cuda) for k in _REGISTRY]
    for k in _REGISTRY:
        k.plain_on_cuda = True
    try:
        yield
    finally:
        for k, flag in saved:
            k.plain_on_cuda = flag


def reset_launch_counts() -> None:
    for k in _REGISTRY:
        k.launches = 0


def uses_plain(kernel: CudaKernel, t: torch.Tensor) -> bool:
    """Whether ``kernel``'s wrapper takes its plain version for tensor ``t``.

    The plain version runs for a CPU tensor (or under the test hook); a CUDA
    tensor launches the kernel; any other device raises.
    """
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{kernel.name}: unsupported device {t.device}")
    return kernel.plain_on_cuda


def refuse_grad(kernel: CudaKernel, *tensors: torch.Tensor) -> None:
    """Raise where the kernel route would silently cut the autograd graph.

    A kernel without an ``autograd.Function`` (the column-major probe
    kernels; K3 and K4 have ``DepthwiseBranches``) has no backward, and an
    output filled through ``ctypes`` has no ``grad_fn``.  On
    the CPU the plain version is differentiable, so returning such a tensor
    would make the two devices give different gradients.  Wrappers call this
    on the kernel route only.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel.name}: the CUDA kernel has no backward; run it under "
            "torch.no_grad() or torch.inference_mode()"
        )


class DevicePtr(ctypes.c_void_p):
    """A tensor's data pointer that remembers the tensor's device."""

    device: torch.device


def ptr(t: torch.Tensor) -> DevicePtr:
    p = DevicePtr(t.data_ptr())
    p.device = t.device
    return p
