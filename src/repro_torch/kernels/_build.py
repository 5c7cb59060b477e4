"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``build/repro_torch/`` at the repository root, named by a
hash of the sources, so an edited kernel rebuilds and an unchanged one is
reused. Building happens at first use, inside the function that launches
the kernel, never when a module is imported; ``build_all`` starts one
``nvcc`` per source at once.

Every C entry takes its pointers (and the CUDA stream) as ``void*`` and
returns ``cudaGetLastError()``; ``check`` raises on a nonzero code.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from torch.utils._python_dispatch import _get_current_dispatch_mode, _pop_mode_temporarily

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_LIBS: dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Counts a wrapper's kernel launches (one per launch, nowhere else); a
    wrapper with several kernels also counts each launch by its route.

    Inside ``recording_launches`` (a CUDA graph capture, which launches
    nothing) a launch is recorded instead of counted, and each replay of
    the graph adds what was recorded (``LaunchRecord.replay``): the counts
    read what the eager path reads."""

    def __init__(self) -> None:
        self.count = 0
        self.routes: dict[str, int] = {}

    def add(self, route: str | None = None) -> None:
        if _recording is not None:
            _recording.launches.append((self, route))
        else:
            self._count(route)

    def _count(self, route: str | None) -> None:
        self.count += 1
        if route is not None:
            self.routes[route] = self.routes.get(route, 0) + 1


@dataclasses.dataclass
class LaunchRecord:
    """The launches one capture recorded, (counter, route) in order."""

    launches: list[tuple[LaunchCounter, str | None]] = dataclasses.field(
        default_factory=list
    )

    def replay(self) -> None:
        """Count every recorded launch once: one replay of the graph."""
        for counter, route in self.launches:
            counter._count(route)


_recording: LaunchRecord | None = None


@contextlib.contextmanager
def recording_launches():
    """Record the launches made inside, without counting them; yields the
    ``LaunchRecord``."""
    global _recording
    if _recording is not None:
        raise RuntimeError("recording_launches does not nest")
    _recording = rec = LaunchRecord()
    try:
        yield rec
    finally:
        _recording = None


def reports_work(name: str, dot_flops):
    """Decorate a kernel wrapper so that it reports its work to an op walk
    (``perf.op_analysis.analyze``), which never sees a ``ctypes`` launch.

    The walk is a dispatch mode, so it lives on the dispatch mode stack of
    the thread that runs it, and of the autograd threads that run its
    backward; a wrapper called where the innermost mode is a walk (it has
    ``report_kernel``) runs with that mode popped, so its plain version's
    ops stay out of the walk on the CPU, then reports one launch of
    ``name`` with ``dot_flops(*args, **kwargs)`` (its plain version's dot
    flops) and its arguments and result. Anywhere else it is the wrapper
    itself."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            walk = _get_current_dispatch_mode()
            if not hasattr(walk, "report_kernel"):
                return fn(*args, **kwargs)
            with _pop_mode_temporarily():
                out = fn(*args, **kwargs)
            walk.report_kernel(name, dot_flops(*args, **kwargs), args, kwargs, out)
            return out

        return run

    return wrap


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed"
        )
    return nvcc


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start compiling ``csrc/<name>.cu`` unless its library is current."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the launch plans
    size their grids to it)."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel_names() -> tuple[str, ...]:
    """Every kernel source: the stems of ``csrc/*.cu``."""
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def build_all(names: tuple[str, ...] | None = None) -> None:
    """Compile every named kernel (default: all of ``csrc/*.cu``) that is
    not current, all at once."""
    jobs = {n: _start(n) for n in (names or kernel_names())}
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)


def load(name: str, entry: str, argtypes: list) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed, with
    the C entry ``entry`` declared to take ``argtypes`` and return an int.

    A library is loaded once, and each of its entries is declared the first
    time it is asked for: a library with several entries (``flash_bwd``)
    gets every one declared, so ctypes never passes a pointer as a 32-bit
    int."""
    lib = _LIBS.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry returned a nonzero ``cudaGetLastError``."""
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
