"""Repo-aware static analysis of the port (``python -m ps_tpu_torch.analysis``).

The port's own copy of the reference's pslint (ROADMAP Queue 1 item
6.5): the same six rule families, the same rule ids and severities, run
over the ``ps_tpu_torch`` tree, its C++ van and its CUDA kernels
(README "Static analysis"). Four families read Python, two cross the
language boundary:

- **PSL1xx concurrency** (:mod:`ps_tpu_torch.analysis.locks`): blocking
  calls under hot locks, foreign condition waits, logging I/O in
  critical sections, inconsistent lock-acquisition order.
- **PSL2xx wire protocol** (:mod:`ps_tpu_torch.analysis.wire`): every
  van message kind named (KIND_NAMES) and handled (dispatch coverage);
  producer/consumer symmetry of ``extra[...]`` header keys.
- **PSL3xx resource safety** (:mod:`ps_tpu_torch.analysis.resources`):
  RecvBufferPool borrow/return pairing, shm segment close/unlink
  pairing, span open/close exception safety, non-daemon threads.
- **PSL4xx knob/doc drift** (:mod:`ps_tpu_torch.analysis.knobs`):
  Config field ↔ ``PS_*`` env mirror ↔ README ↔ config docstrings, plus
  PSL406, raw ``os.environ`` reads of ``PS_*`` names outside the Config
  module.
- **PSL5xx native concurrency & ownership**
  (:mod:`ps_tpu_torch.analysis.native`, over the clang-free C++/CUDA
  model in :mod:`ps_tpu_torch.analysis.cpp`): lock-order cycles against
  the declared ``tmu -> wmu`` hierarchy, blocking/allocating under
  ``hot-lock`` mutexes, the ``wait_for`` ban, and malloc/free pairing
  against ``// pslint: owns:``/``transfers:`` annotations. It reads the
  kernels' ``.cu`` sources too; a kernel holds no host mutex.
- **PSL6xx cross-language ABI drift** (:mod:`ps_tpu_torch.analysis.abi`):
  every ``extern "C"`` signature of the van and of each kernel library
  diffed against the ctypes sites that bind that library (arity, the
  width and kind of each parameter — ``long long``, ``float`` and
  ``double`` included — and the return type), calls without
  declarations, and exported-but-never-bound symbols.

Run as a gate: ``python -m ps_tpu_torch.analysis ps_tpu_torch/`` must
exit 0; ``tests/test_torch_analysis.py`` enforces the same. Suppress a
deliberate violation inline, with a reason (the C++ spelling is the
same after ``//``)::

    blocking_call()  # pslint: disable=PSL101 -- bounded by stall_timeout

(the reason is mandatory — PSL001 fires on a bare suppression).
"""

from ps_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    RepoIndex,
    all_rules,
    run_lint,
)

__all__ = ["Finding", "RepoIndex", "all_rules", "run_lint"]
