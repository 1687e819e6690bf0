"""The native van (C++), compiled at first use with the host's ``g++``.

Counterpart of ``ps_tpu/native/__init__.py``. ``van.cpp`` beside this file
is a byte-for-byte copy of ``ps_tpu/native/van.cpp`` (a test holds the two
equal), so the frames the port sends are the reference's frames by
construction. :func:`load` compiles it once into ``build/ps_tpu_torch/``
at the root of the checkout, named by the source's hash, with an atomic
rename so concurrent builders race safely, and returns a ``ctypes.CDLL``.
This is host code: ``g++``, not ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parents[1] / "build" / "ps_tpu_torch"
_lock = threading.Lock()
_cache: dict = {}


class NativeBuildError(RuntimeError):
    pass


def library_path(name: str = "van") -> Path:
    """Where the built library of ``name.cpp`` lives (keyed on its hash)."""
    digest = hashlib.sha256((_DIR / f"{name}.cpp").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def load(name: str = "van") -> ctypes.CDLL:
    """Compile (if needed) and dlopen the named native component."""
    with _lock:
        if name in _cache:
            return _cache[name]
        lib = library_path(name)
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(lib.name + f".tmp{os.getpid()}")
            cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                   "-pthread", "-o", str(tmp), str(_DIR / f"{name}.cpp")]
            try:
                subprocess.run(cmd, check=True, capture_output=True,
                               text=True)
            except subprocess.CalledProcessError as e:
                raise NativeBuildError(
                    f"building {name}.cpp failed:\n{e.stderr}") from None
            os.replace(tmp, lib)  # atomic: concurrent builders race safely
        _cache[name] = ctypes.CDLL(str(lib))
        return _cache[name]
