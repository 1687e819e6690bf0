"""Process-level init/shutdown and the global runtime context.

Counterpart of ``ps_tpu/api.py``: ``init(backend=...)`` builds the backend
once per process, ``shutdown()`` drops it. Here:

- ``backend='cuda'`` (default; the counterpart of 'tpu'): the fused
  server on one device, sync or async (DC-ASGD).
- ``backend='local'``: the single-process local PS (the reference's
  config 1): per-key push/pull, sync aggregation over
  ``Config.num_workers`` logical workers, or async.

Either places everything on ``cuda:0`` unless the caller asks for
``device='cpu'``. With no GPU present it raises; it never carries on on
the CPU by itself.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from ps_tpu_torch.config import Config


class Context:
    """The live runtime created by :func:`init`: the config, the backend
    engine and the one ``torch.device`` everything is placed on."""

    def __init__(self, config: Config, backend, device: torch.device):
        self.config = config
        self.backend = backend
        self.device = device

    @property
    def num_workers(self) -> int:
        return self.backend.num_workers


_lock = threading.Lock()
_context: Optional[Context] = None


def init(backend: Optional[str] = None, config: Optional[Config] = None,
         **overrides) -> Context:
    """Initialize ps_tpu_torch. Single-shot per process: a second call
    raises until :func:`shutdown` resets the runtime.

    Args:
      backend: 'cuda' or 'local'; overrides config.backend.
      config: full Config; default is ``Config.from_env()``.
      **overrides: any Config field, e.g. ``device='cpu'``.
    """
    global _context
    with _lock:
        if _context is not None:
            raise RuntimeError(
                "ps_tpu_torch already initialized; call shutdown() first")
        if config is None:
            config = Config.from_env(**overrides)
        elif overrides:
            config = Config(**{**config.__dict__, **overrides})
        if backend is not None:
            config = Config(**{**config.__dict__, "backend": backend})
        if config.backend == "local":
            from ps_tpu_torch.backends.local import LocalBackend

            be = LocalBackend(config)
        else:
            from ps_tpu_torch.backends.cuda import CudaBackend

            be = CudaBackend(config)
        _context = Context(config, be, device=be.device)
        return _context


def shutdown(abort: bool = False) -> None:
    """Tear down the backend (its ``shutdown(abort=...)``, where it has
    one) and drop the context so a fresh :func:`init` can follow.
    ``abort=True`` is the reference's post-failure path, which skips
    barriers; the one-device backends have none to skip."""
    global _context
    with _lock:
        if _context is not None:
            backend_shutdown = getattr(_context.backend, "shutdown", None)
            if backend_shutdown is not None:
                backend_shutdown(abort=abort)
            _context = None


def is_initialized() -> bool:
    return _context is not None


def current_context() -> Context:
    if _context is None:
        raise RuntimeError(
            "ps_tpu_torch is not initialized; call ps_tpu_torch.init() first")
    return _context
