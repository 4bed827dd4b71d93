"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on
first use into ``build/kernels/<name>-<hash>.so`` at the repository root
(``.gitignore`` lists ``build/``), keyed by a hash of the source, every
header under ``csrc/``, the flags and the include paths they name, so an
edited source or header rebuilds and an unchanged one loads at once.
Nothing is built when a module is imported: CPU-only installs import
every module and never call here.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": build time (0.0 when the cached library loaded),
#: "ptxas": the compiler's register/shared-memory report}
BUILD_INFO: dict[str, dict] = {}


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (put it on PATH or set CUDA_HOME)")


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _include_dirs(flags) -> list[str]:
    """The paths of ``-I<dir>`` and ``-I <dir>`` in ``flags``."""
    dirs = []
    for i, flag in enumerate(flags):
        if flag == "-I" and i + 1 < len(flags):
            dirs.append(flags[i + 1])
        elif flag.startswith("-I") and len(flag) > 2:
            dirs.append(flag[2:])
    return dirs


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    for inc in _include_dirs(NVCC_FLAGS):
        digest.update(b"\0" + str(Path(inc).resolve()).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return out, None, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp), time.perf_counter()


def _finish(name: str, out: Path, pending, t0: float) -> None:
    if pending is None:
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "ptxas": ""})
        return
    proc, tmp = pending
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}


def build_all() -> dict[str, dict]:
    """Compile every source that has no current library, one ``nvcc``
    per source, all started together. Returns :data:`BUILD_INFO`."""
    with _LOCK:
        started = [(n, *_start(n)) for n in sources()]
        errors = []
        for name, out, pending, t0 in started:
            try:
                _finish(name, out, pending, t0)
            except KernelBuildError as e:
                errors.append(str(e))
        if errors:
            raise KernelBuildError("\n".join(errors))
    return BUILD_INFO


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            out, pending, t0 = _start(name)
            _finish(name, out, pending, t0)
            lib = ctypes.CDLL(str(out))
            _LOADED[name] = lib
        return lib
