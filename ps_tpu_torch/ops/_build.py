"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library, loaded with
``ctypes``. Nothing includes PyTorch's headers, so a build takes seconds.
Libraries go to ``build/ps_tpu_torch/`` at the root of the checkout, named
by a hash of the source, every header under ``csrc/`` and the flags, so an
edited source or header is rebuilt and an unchanged one is loaded as it
is. A missing ``nvcc`` or a failed build
raises: there is no fall back to a kernel's plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

#: every kernel of the port: csrc/<name>.cu
KERNELS = ("sparse_group", "sparse_apply", "flash_attention", "lamb_apply")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ps_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH`` or under ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (not on PATH, not /usr/local/cuda/bin/nvcc): the "
        "CUDA kernels are built from source at first use")


def _library_path(name: str) -> Path:
    """The library's path, named by a hash of ``csrc/<name>.cu``, every
    header under ``csrc/`` (any source may include any of them) and the
    flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(p for p in CSRC.rglob("*") if p.suffix in (".cuh", ".h"))
    for path in (CSRC / f"{name}.cu", *headers):
        digest.update(str(path.relative_to(CSRC)).encode() + b"\0")
        digest.update(path.read_bytes() + b"\0")
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library is built; returns the
    process (or None) and the library path."""
    out = _library_path(name)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return (proc, tmp), out


def _finish(name: str, started, out: Path) -> None:
    if started is None:
        return
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build(names: Iterable[str]) -> None:
    """Build every named kernel library, one nvcc for each source, all
    started together."""
    with _lock:
        jobs = [(name, *_start(name)) for name in names]
        for name, started, out in jobs:
            _finish(name, started, out)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_library_path(name)))
        return _libs[name]
