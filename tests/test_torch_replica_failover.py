"""The replication failover drill with real processes and a real SIGKILL,
against the reference's ``tests/test_replica_failover.py``, on the CPU.

A port primary and its warm backup (replication attached, the primary
beating the backup's ``PromotionWatch``), and a worker training the
MNIST MLP through the replica set, are processes of
``tests/test_torch_van_harness.py`` (``replica-*`` roles). After step
``KILL_AT`` the primary is SIGKILLed; the worker's next push meets it
dead, the backup's watch declares it dead on the heartbeat horizon and
promotes ("timeout", never "goodbye": a killed process says none), and
the worker re-routes, replays its push (exactly once by its dedup token)
and finishes the run, which is not restarted.

- Sync ack: the losses and the final params are bitwise an unkilled run's
  of the same topology, and the promoted backup applied each push once.
- Async ack: the losses before the kill are bitwise the unkilled run's;
  after it the run goes on, finite, and learns (at most the ack window is
  lost).

The reference's drill races its kill against the worker's next push; here
the worker waits for the kill to land before pushing again, so every run
fails over. Each drill test runs the topology twice (~12 s). A third test
runs the async trainer's replication flags as a user would (~6 s).
"""

import json
import signal

import numpy as np
import pytest

from tests import test_torch_van_harness as harness

STEPS, KILL_AT = 12, 5
WATCH_TIMEOUT_MS = 500


def _wait(path, proc=None, timeout=120):
    import time

    deadline = time.monotonic() + timeout
    while not path.exists():
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"{proc.args} exited {proc.returncode}:\n"
                                 f"{proc.communicate()[0]}")
        assert time.monotonic() < deadline, f"{path} never appeared"
        time.sleep(0.01)


def _run_drill(out, ack, kill):
    """One run of the topology: (worker.json, backup.json, the worker's
    and the backup's final params)."""
    out.mkdir()
    watch = harness.free_port(harness.socket.SOCK_DGRAM)
    backup = harness.spawn("replica-backup", out, watch, WATCH_TIMEOUT_MS,
                           "cpu")
    primary = harness.spawn("replica-primary", out, watch, ack, 256, "cpu")
    procs = [backup, primary]
    try:
        _wait(out / "primary.ready", primary)
        worker = harness.spawn("replica-worker", out, STEPS,
                               KILL_AT if kill else -1, "cpu")
        procs.append(worker)
        if kill:
            _wait(out / "killpoint", worker)
            primary.send_signal(signal.SIGKILL)
            primary.wait(timeout=30)
            assert primary.returncode == -signal.SIGKILL
            (out / "killed").write_text("1")
        wout = worker.communicate(timeout=120)[0]
        assert worker.returncode == 0, f"worker:\n{wout}"
        (out / "done").write_text("1")
        for p, name in ((backup, "backup"),) + (() if kill else
                                                 ((primary, "primary"),)):
            o = p.communicate(timeout=60)[0]
            assert p.returncode == 0, f"{name}:\n{o}"
        w = json.loads((out / "worker.json").read_text())
        b = json.loads((out / "backup.json").read_text())
        return (w, b, dict(np.load(out / "worker_params.npz")),
                dict(np.load(out / "backup_params.npz")))
    finally:
        harness.kill_all(procs)


def test_kill_primary_mid_push_sync_ack_bitwise_continuation(tmp_path):
    """SIGKILL mid-training, promotion on the heartbeat timeout, the job
    goes on without a restart, and the sync-ack run is bitwise the
    unkilled one."""
    ref_w, ref_b, ref_p, _ = _run_drill(tmp_path / "ref", "sync", kill=False)
    assert ref_b["role"] == "backup"  # the unkilled run never promoted
    assert len(ref_w["losses"]) == STEPS and ref_w["failovers"] == 0

    w, b, p, bp = _run_drill(tmp_path / "drill", "sync", kill=True)
    assert (b["role"], b["promote_reason"], b["epoch"]) == (
        "primary", "timeout", 1)
    assert b["detect_age_ms"] >= WATCH_TIMEOUT_MS
    assert w["failovers"] >= 1 and w["epochs"] == [1]
    assert len(w["losses"]) == STEPS
    np.testing.assert_array_equal(np.array(w["losses"]),
                                  np.array(ref_w["losses"]))
    for k in ref_p:
        np.testing.assert_array_equal(p[k], ref_p[k], err_msg=k)
        np.testing.assert_array_equal(bp[k], ref_p[k], err_msg=k)
    assert w["losses"][-1] < w["losses"][0], "did not learn"
    # every step's push applied once at the surviving replica
    assert b["version"] == STEPS


def test_kill_primary_mid_push_async_ack_bounded_divergence(tmp_path):
    """Async ack trades the per-commit round trip to the backup for a
    bounded loss on failover: the losses up to the kill are bitwise the
    unkilled run's, and the run goes on and learns."""
    ref_w, _, _, _ = _run_drill(tmp_path / "ref", "async", kill=False)
    w, b, _, _ = _run_drill(tmp_path / "drill", "async", kill=True)
    assert (b["role"], b["promote_reason"]) == ("primary", "timeout")
    assert len(w["losses"]) == STEPS and w["failovers"] >= 1
    np.testing.assert_array_equal(np.array(w["losses"][:KILL_AT + 1]),
                                  np.array(ref_w["losses"][:KILL_AT + 1]))
    post = np.array(w["losses"][KILL_AT + 1:])
    assert np.isfinite(post).all()
    assert w["losses"][-1] < w["losses"][0], "did not learn"
    # at most the window's commits lost, none applied twice
    assert STEPS - 256 <= b["version"] <= STEPS


def test_trainer_replication_flags_reach_the_services(tmp_path):
    """The async trainer's replication flags, as a user runs them: a
    ``--backup --watch-port`` server, a primary with ``--replicate-to
    --beat --replica-ack async --replica-window 8``, one worker on the
    replica set. The primary streams every pull and push to the backup
    with async ack, and its planned leave (a goodbye beat) promotes the
    backup with reason "goodbye"."""
    import subprocess
    import time

    pp, pb = harness.free_port(), harness.free_port()
    watch = harness.free_port(harness.socket.SOCK_DGRAM)
    trainer = "ps_tpu_torch.examples.train_mnist_async"
    common = ["--device", "cpu", "--num-workers", 1]
    backup = harness.spawn("--role", "server", "--port", pb, "--backup",
                           "--watch-port", watch, *common, module=trainer)
    procs = [backup]
    try:
        primary = harness.spawn(
            "--role", "server", "--port", pp, "--replicate-to",
            f"127.0.0.1:{pb}", "--beat", f"127.0.0.1:{watch}",
            "--replica-ack", "async", "--replica-window", 8,
            "--dump", tmp_path, *common, module=trainer)
        procs.append(primary)
        # workers come once the primary attached (its line says so)
        deadline = time.monotonic() + 60
        line = ""
        while "replicating to" not in line:
            assert time.monotonic() < deadline and primary.poll() is None
            line = primary.stdout.readline()
        assert "[async, window 8]" in line, line
        worker = harness.spawn(
            "--role", "worker", "--server",
            f"127.0.0.1:{pp}|127.0.0.1:{pb}", "--worker-id", 0,
            "--steps", 6, *common[:2], module=trainer)
        procs.append(worker)
        out = worker.communicate(timeout=120)[0]
        assert worker.returncode == 0, out
        out = primary.communicate(timeout=60)[0]
        assert primary.returncode == 0, out
        info = json.loads((tmp_path / "server.json").read_text())
        repl = info["replica"]["repl"]
        assert repl["ack"] == "async" and not repl["degraded"], repl
        assert info["replica"]["repl_entries"] == 13  # 7 pulls, 6 pushes
        deadline = time.monotonic() + 30
        text = ""
        while "now serving workers" not in text:
            assert time.monotonic() < deadline, text
            text += backup.stdout.readline()
        assert "reason=goodbye" in text and "13 replicated events" in text
    finally:
        harness.kill_all(procs)
        for p in procs:
            try:
                p.communicate(timeout=10)
            except (ValueError, subprocess.TimeoutExpired):
                pass
