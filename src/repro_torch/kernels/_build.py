"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), under ``build/repro_torch/<hash>/`` at the repository root;
that directory is listed in ``.gitignore``.  The hash covers the source and
the flags, so an edited kernel is rebuilt and a stale library is never
loaded.  Nothing is built when a module is imported: :func:`load` builds on
the first call that needs a kernel, and :func:`build_all` builds every
source at once, one ``nvcc`` process per source, all started together.

A build that cannot run or fails raises :class:`KernelBuildError`, and a
wrapper whose launch returns a CUDA error raises :class:`KernelLaunchError`:
faults of the card's toolchain and runtime, which the resilient serving
path lets through instead of turning them into statuses.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_ROOT", "NVCC_FLAGS", "KernelBuildError",
           "KernelLaunchError", "sources", "load", "build_all",
           "compile_units"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")



class KernelBuildError(RuntimeError):
    """A kernel source could not be built: no ``nvcc``, or it failed."""


class KernelLaunchError(RuntimeError):
    """A kernel's launch returned a CUDA error."""


_loaded: dict[str, ctypes.CDLL] = {}
_logs: dict[str, str] = {}


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start ``nvcc`` for one source unless its library is built; the
    output goes to a temporary name and is renamed when complete."""
    out = _target(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    _logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    _log_path(out).write_text(log)
    os.replace(tmp, out)


def _log_path(lib: Path) -> Path:
    """Where the compiler log of a built library is kept beside it."""
    return lib.with_suffix(".log")


def _cached_log(name: str) -> str:
    log = _log_path(_target(name))
    return log.read_text() if log.exists() else "(cached)"


def build_all() -> dict:
    """Build every kernel source in parallel; returns the seconds taken and
    each build's compiler log (``-Xptxas -v``: registers, spills), kept
    beside the library, so a cached build reports it too."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in sources()}
    for name, job in jobs.items():
        if job is not None:
            _finish(name, job)
    return {"seconds": time.perf_counter() - t0,
            "logs": {name: _logs.get(name) or _cached_log(name)
                     for name in jobs}}


def compile_units(units: dict[str, tuple[Path, Path]]) -> dict[str, str]:
    """Compile each named ``(source, library)`` pair with ``NVCC_FLAGS``,
    one ``nvcc`` process each, all started together (for scripts that build
    variants of a kernel source); returns each compiler log and raises if a
    build fails."""
    jobs = {name: subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (src, lib) in units.items()}
    logs = {name: proc.communicate()[0] for name, proc in jobs.items()}
    for name, proc in jobs.items():
        if proc.returncode:
            raise KernelBuildError(f"nvcc failed for {name} (exit "
                               f"{proc.returncode}):\n{logs[name]}")
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = _loaded[name] = ctypes.CDLL(str(_target(name)))
    return lib
