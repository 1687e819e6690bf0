"""The host control plane: framed tensor messages over the native TCP van
(``tensor_van``) and heartbeat liveness (``heartbeat``).

Counterpart of ``ps_tpu/control/``. A dead peer process surfaces as a
typed :class:`WorkerFailureError` instead of a hung collective. The
shared-memory lane (``shm_lane.py``) and the native epoll serve loop
(``native_loop.py``) are not ported yet (ROADMAP Queue 1 item 5).
"""

from ps_tpu_torch.control.heartbeat import (
    FailureDetector,
    HeartbeatClient,
    HeartbeatServer,
    WorkerFailureError,
)

__all__ = [
    "FailureDetector",
    "HeartbeatClient",
    "HeartbeatServer",
    "WorkerFailureError",
]
