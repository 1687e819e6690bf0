"""A dense async store served across ranks (``backends/op_stream.py``).

Two gloo ranks on the CPU serve one async store through ``serve_async``:
rank 0 runs the van service and sends every engine call to rank 1 as an
op of its stream, which rank 1 runs in the same order. One spawned group
(``tests/test_torch_ranks_harness.py``'s ``served`` case) serves, in
order, a primary and a backup under 'replicated' (sgd, thread per
connection) and under 'sharded' (adam, whose moments each rank holds in
blocks, on the native loop), while this process drives them with the
same frames it then sends to two other targets: the same services of the
port in one process, and the reference's ``AsyncPSService`` on a
2-device CPU mesh (``ps_tpu.init(backend="tpu", mode="async",
mesh_shape={"data": 2})``). The helpers of a scenario (a shard a move
goes to, a spare, a one-process primary) are port services in this
process in every run.

- a primary (A): pushes (serial, a replay, the bucketed transport),
  READ and NOT_MODIFIED, ``checkpoint_all`` restored into one process, a
  live move of half the keys out to a one-process shard and back, a
  RESEED onto a one-process spare that then follows and is promoted;
- a backup (D) booted on placeholder keys: a one-process primary's
  RESEED installs its ``REPLICA_SEED``, it follows that primary's
  stream, is promoted and serves pushes.

Every reply, every rank's final rows (parameters, optimizer state, stale
snapshots, apply counts) and the counters are bitwise the one-process
run's and within rtol 1e-6 / atol 1e-7 of the reference's (its own
bound); READ and NOT_MODIFIED replies are byte for byte (births fixed to
one stamp). The ranks hold bitwise the same state; rank 1 ran exactly
rank 0's ops, which READs and native admission's replay acks never
send. Apart from the group: at 4 ranks a served push is bitwise its
one-process apply (the mean of four copies of a gradient would not be),
and a follower killed mid-run ends in a typed failure at the worker
within the heartbeat timeout.
"""

import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ps_tpu
import ps_tpu_torch
import test_torch_ranks_harness as torch_ranks
from ps_tpu_torch.backends.common import ServerFailureError
from ps_tpu_torch.backends.remote_async import connect_async, serve_async
from ps_tpu_torch.control import tensor_van as tv
from ps_tpu_torch.obs import freshness

PLACEMENTS = ("replicated", "sharded")
OPT = {"replicated": ("sgd", {"learning_rate": 0.1}),
       "sharded": ("adam", {"learning_rate": 0.01})}
NATIVE = {"replicated": False, "sharded": True}
LAM, WORKERS = 0.04, 2
INIT = {"mode": "async", "num_workers": WORKERS, "dc_lambda": LAM}
TOL = {"rtol": 1e-6, "atol": 1e-7}
FIXED_BIRTH = {"birth": 1700000000.5, "bmono": 123.25, "bpid": "served"}
SHAPES = {"a/w": (16, 8), "b/w": (32,), "c/k": (8, 6), "d/b": (5,)}
MOVED = ["a/w", "d/b"]
BUCKET_BYTES = 256


def _tree(seed, scale=1.0, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in shapes.items()}


PARAMS = _tree(0)
GRADS = [_tree(100 + i, 0.1) for i in range(12)]
SPARE = {"z/ph": np.zeros(4, np.float32)}   # a spare's placeholder keys
SHARD_B = {"y/ph": np.ones(3, np.float32)}  # the move target's own key


_like = torch_ranks.like
_Drive = torch_ranks.Drive
_rows = torch_ranks.served_rows


def _stamp(wall=None, mono=None):
    return dict(FIXED_BIRTH)


# -- the scenarios: frames to a target and its helpers --------------------------


def _scenario_a(port, helpers, ckpt):
    """The primary's frames (``scenario_primary`` of the harness, which
    ``chip_smoke.py`` phase 27 drives on the card too); ``helpers`` holds
    the ports of B (a one-process shard a move goes to and comes back
    from) and C (a one-process spare)."""
    return torch_ranks.scenario_primary(port, helpers["B"], helpers["C"],
                                        ckpt, PARAMS, GRADS, MOVED,
                                        BUCKET_BYTES)


def _scenario_d(port, helpers):
    """The backup's frames: the one-process primary E re-seeds it, its
    stream runs, then it is promoted and serves."""
    e = helpers["E"]
    d = _Drive()
    try:
        d.req("e_pull0", e, tv.PULL, 0)
        d.req("e_push0", e, tv.PUSH, 0, GRADS[8], {"pseq": 1, "pnonce": "m0"})
        d.req("e_reseed", e, tv.RESEED, 0, None,
              {"spare": f"127.0.0.1:{port}"})
        d.req("e_pushpull1", e, tv.PUSH_PULL, 1, GRADS[9],
              {"pseq": 1, "pnonce": "m1"})
        d.req("e_push0b", e, tv.PUSH, 0, GRADS[10],
              {"pseq": 2, "pnonce": "m0"})
        d.req("promote", port, tv.REPLICA_PROMOTE, 0, None,
              {"reason": "test"})
        d.req("hello", port, tv.HELLO, 0)
        d.req("replay", port, tv.PUSH, 0, GRADS[10],
              {"pseq": 2, "pnonce": "m0"})
        d.req("pushpull0", port, tv.PUSH_PULL, 0, GRADS[11],
              {"pseq": 3, "pnonce": "m0"})
        d.req("read", port, tv.READ, 0)
    finally:
        d.close()
    return {"replies": d.replies}


def _port_store(params, placement):
    opt, kw = OPT[placement]
    st = ps_tpu_torch.KVStore(optimizer=opt, mode="async", **kw)
    st.init(_like(params))
    return st


class _Helpers:
    """A scenario's one-process port services in this process."""

    def __init__(self, placement):
        self.placement = placement
        self.svcs = {}

    def start(self, which):
        p = self.placement
        if "B" in which:
            self.svcs["B"] = serve_async(_port_store(SHARD_B, p))
        if "C" in which:
            self.svcs["C"] = serve_async(_port_store(SPARE, p), backup=True)
        if "E" in which:
            self.svcs["E"] = serve_async(_port_store(PARAMS, p))
        return {n: s.port for n, s in self.svcs.items()}

    def rows(self, name):
        return _rows(self.svcs[name]._engine)

    def stop(self):
        for s in self.svcs.values():
            s.stop()


def _drive_a(placement, port, ckpt):
    h = _Helpers(placement)
    try:
        out = _scenario_a(port, h.start("BC"), ckpt)
        out["C"] = h.rows("C")
        out["B_keys"] = sorted(h.svcs["B"]._key_order)
    finally:
        h.stop()
    return out


def _drive_d(placement, port):
    h = _Helpers(placement)
    try:
        out = _scenario_d(port, h.start("E"))
        out["E"] = h.rows("E")
    finally:
        h.stop()
    return out


def _restored(ckpt, placement):
    """A checkpoint of either port run restored into one process."""
    st = _port_store(PARAMS, placement)
    st.restore(ckpt, elastic=True)
    return _rows(st._engine)


# -- the three runs ---------------------------------------------------------------


def _ranks_run(tmp):
    ctl = tmp / "ctl"
    ctl.mkdir()
    cases, names = [], []
    for placement in PLACEMENTS:
        opt, kw = OPT[placement]
        common = dict(optimizer=opt, opt_kw=kw, placement=placement,
                      ctl=str(ctl), stamp=FIXED_BIRTH)
        cases += [("served", dict(common, params=PARAMS,
                                  name=f"A-{placement}",
                                  native_loop=NATIVE[placement],
                                  probe=True)),
                  ("served", dict(common, params=SPARE, backup=True,
                                  name=f"D-{placement}"))]
        names += [f"A-{placement}", f"D-{placement}"]
    run = torch_ranks.start_ranks(2, cases, tmp, init=INIT)
    out = {}
    try:
        for name in names:
            port = _wait_port(ctl / f"{name}.port", run)
            placement = name.split("-", 1)[1]
            if name.startswith("A"):
                out[name] = _drive_a(placement, port,
                                     str(tmp / f"ckpt-{name}"))
            else:
                out[name] = _drive_d(placement, port)
            (ctl / f"{name}.done").write_text("done")
    finally:
        for name in names:  # a failed drive still lets the ranks end
            (ctl / f"{name}.done").write_text("done")
    results = run.finish(wall_s=120)
    for i, name in enumerate(names):
        out[name]["ranks"] = [r[i] for r in results]
    return out


def _wait_port(path, run, timeout=60.0):
    t0 = time.monotonic()
    while not path.exists():
        dead = [r for r, p in enumerate(run.procs) if p.poll() is not None]
        if dead:
            run.finish(wall_s=5)  # raises with the rank's log
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.02)
    return int(path.read_text())


def _one_run(tmp):
    out = {}
    for placement in PLACEMENTS:
        svc = serve_async(_port_store(PARAMS, placement),
                          native_loop=NATIVE[placement])
        try:
            out[f"A-{placement}"] = _drive_a(placement, svc.port,
                                             str(tmp / f"one-{placement}"))
        finally:
            svc.stop()
        out[f"A-{placement}"]["final"] = _rows(svc._engine)
        svc = serve_async(_port_store(SPARE, placement), backup=True)
        try:
            out[f"D-{placement}"] = _drive_d(placement, svc.port)
        finally:
            svc.stop()
        out[f"D-{placement}"]["final"] = _rows(svc._engine)
    return out


def _ref_scalar_count(mp):
    """R11: the reference's ``adopt_key`` refuses a row whose 0-dim state
    leaf (adam's ``count``) crossed the van, which carries it as shape
    ``(1,)`` in both packages: its recipients take the one element back
    to shape ``()`` here, as the port's ``state_from_reference`` does."""
    from ps_tpu.backends.tpu import AsyncTpuServer

    adopt = AsyncTpuServer.adopt_key

    def adopt_key(self, k, param, state_kv, stale, apply_count=0):
        state_kv = {p: (np.asarray(v).reshape(())
                        if p.endswith("/count") and np.shape(v) == (1,)
                        else v) for p, v in state_kv.items()}
        return adopt(self, k, param, state_kv, stale, apply_count)

    mp.setattr(AsyncTpuServer, "adopt_key", adopt_key)


def _ref_run(tmp, mp):
    from ps_tpu.backends.remote_async import serve_async as ref_serve

    _ref_scalar_count(mp)
    out = {}
    ps_tpu.init(backend="tpu", mode="async", num_workers=WORKERS,
                dc_lambda=LAM, mesh_shape={"data": 2})
    try:
        for placement in PLACEMENTS:
            opt, kw = OPT[placement]

            def store(params):
                st = ps_tpu.KVStore(optimizer=opt, mode="async",
                                    placement=placement, **kw)
                st.init({k: jnp.asarray(v) for k, v in params.items()})
                return st

            svc = ref_serve(store(PARAMS), native_loop=NATIVE[placement])
            try:
                out[f"A-{placement}"] = _drive_a(placement, svc.port,
                                                 str(tmp / f"ref-{placement}"))
            finally:
                svc.stop()
            out[f"A-{placement}"]["final"] = _rows(svc._engine)
            svc = ref_serve(store(SPARE), backup=True)
            try:
                out[f"D-{placement}"] = _drive_d(placement, svc.port)
            finally:
                svc.stop()
            out[f"D-{placement}"]["final"] = _rows(svc._engine)
    finally:
        ps_tpu.shutdown()
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from ps_tpu.obs import freshness as ref_freshness

    tmp = tmp_path_factory.mktemp("served")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(freshness, "birth_record", _stamp)
        mp.setattr(ref_freshness, "birth_record", _stamp)
        ps_tpu_torch.init(backend="cuda", device="cpu", **INIT)
        try:
            runs = {"ranks": _ranks_run(tmp), "one": _one_run(tmp),
                    "ref": _ref_run(tmp, mp)}
            for placement in PLACEMENTS:
                name = f"A-{placement}"
                for run in ("ranks", "one"):
                    runs[run][name]["restored"] = _restored(
                        str(tmp / (f"ckpt-{name}" if run == "ranks"
                                   else f"one-{placement}")), placement)
        finally:
            ps_tpu_torch.shutdown()
    return runs


# -- comparisons -------------------------------------------------------------------


def _same_reply(got, want, tag, exact):
    torch_ranks.same_reply(got, want, tag, None if exact else TOL)


def _same_rows(got, want, what, exact):
    torch_ranks.same_rows(got, want, what, None if exact else TOL)


def _against_one_and_ref(served, name, tags):
    for tag in tags:
        ranks = served["ranks"][name]["replies"][tag]
        _same_reply(ranks, served["one"][name]["replies"][tag], tag, True)
        _same_reply(ranks, served["ref"][name]["replies"][tag], tag, False)


# -- the tests ---------------------------------------------------------------------


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_pushes_serial_and_bucketed(served, placement):
    """PUSH, PULL, PUSH_PULL, a replayed push (dedup) and a bucketed
    push_pull: replies bitwise the one-process run's, within the bound of
    the reference's mesh."""
    name = f"A-{placement}"
    _against_one_and_ref(served, name, (
        "hello", "pull0", "pull1", "push0", "pushpull1", "push0b",
        "replay0b", "pushpull0"))
    assert served["ranks"][name]["replies"]["replay0b"]["extra"]["dedup"]
    got = served["ranks"][name]["bucketed"]
    for k, v in served["one"][name]["bucketed"].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_allclose(got[k], served["ref"][name]["bucketed"][k],
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_read_and_not_modified_reply_bytes(served, placement):
    """A READ answers from rank 0's own tensors (whole on every rank):
    its bytes are the one-process run's, and NOT_MODIFIED's the
    reference's too."""
    name = f"A-{placement}"
    tags = ("read", "read_nm", "read_old", "read_ckpt", "read_final")
    _against_one_and_ref(served, name, tags)
    replies = served["ranks"][name]["replies"]
    assert replies["read_nm"]["kind"] == tv.NOT_MODIFIED
    assert replies["read_nm"]["raw"] == \
        served["ref"][name]["replies"]["read_nm"]["raw"]
    assert replies["read_old"]["raw"] == replies["read"]["raw"]


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_reads_and_replay_acks_send_no_op(served, placement):
    """Rank 1 ran exactly rank 0's ops, and those are the engine calls
    the event log records: a pull and a push each, none for a READ or a
    replayed push (deduplicated by the pump, or acked by native admission
    with no engine call on the loop)."""
    name = f"A-{placement}"
    r0, r1 = served["ranks"][name]["ranks"]
    assert r1["by_op"] == r0["by_op"]
    assert (r1["ops"], r1["op_bytes"]) == (r0["ops"], r0["op_bytes"])
    events = [op for op, _ in r0["event_log"]]
    assert r0["by_op"]["pull"] == events.count("pull")
    pushes = r0["by_op"].get("push", 0) + r0["by_op"].get("push_sub", 0)
    assert pushes == events.count("push")
    assert "read" not in r0["by_op"]
    assert r0["by_op"]["save"] == 1 and r0["by_op"]["stop"] == 1
    assert r0["by_op"]["evict"] == 1
    assert r0["by_op"]["adopt"] == len(MOVED)
    if NATIVE[placement]:
        assert r0["admit"]["acks"] >= 1, r0["admit"]
    for r in (r0, r1):  # the served path runs no kernel of the port
        assert not any(r["launches"].values()), r["launches"]


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_checkpoint_all_restores_bitwise_into_one_process(served, placement):
    """``checkpoint_all`` of the two ranks (one file a rank), restored
    with ``elastic=True`` into one process: bitwise the one-process run's
    checkpoint restored so, and its parameters the READ taken right after
    the checkpoint (the reference's within its bound)."""
    name = f"A-{placement}"
    got = served["ranks"][name]["restored"]
    _same_rows(got, served["one"][name]["restored"], "restored", True)
    for which, exact in (("ranks", True), ("ref", False)):
        read = served[which][name]["replies"]["read_ckpt"]["tensors"]
        for k, v in read.items():
            torch_ranks._same_array(got["params"][k], v, f"ckpt {which} {k}",
                                    None if exact else TOL)
    assert served["ranks"][name]["ckpt_versions"] == \
        served["ref"][name]["ckpt_versions"]


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_live_move_out_and_back(served, placement):
    """Half the keys move to a one-process port shard and back (donor,
    then recipient): the replies, a push on the keys left meanwhile, and
    the shard's key range after."""
    name = f"A-{placement}"
    _against_one_and_ref(served, name, ("move_out", "push_rest",
                                        "move_back", "pushpull1b"))
    for run in ("ranks", "one", "ref"):
        assert served[run][name]["B_keys"] == sorted(SHARD_B)
    assert served["ranks"][name]["replies"]["move_out"]["extra"][
        "keys"] == MOVED


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_reseed_onto_a_one_process_spare(served, placement):
    """RESEED from the two ranks onto a one-process spare, which follows
    the stream and is promoted: its rows are the primary's, bitwise the
    one-process run's spare, within the bound of the reference's."""
    name = f"A-{placement}"
    _against_one_and_ref(served, name, ("reseed", "push_repl", "pull_repl",
                                        "promote_c", "read_c"))
    got = served["ranks"][name]["C"]
    _same_rows(got, served["one"][name]["C"], "spare", True)
    _same_rows(got, served["ref"][name]["C"], "spare vs ref", False)
    primary = served["ranks"][name]["ranks"][0]
    for k, v in primary["params"].items():
        np.testing.assert_array_equal(got["params"][k], v, err_msg=k)


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_replica_seed_onto_a_two_rank_spare(served, placement):
    """A one-process primary re-seeds the two ranks, booted as a backup
    on placeholder keys (REPLICA_SEED: evict, adopt, meta as ops); they
    follow its stream, are promoted and serve: every reply and every
    rank's rows bitwise the one-process backup's, within the bound of
    the reference's mesh."""
    name = f"D-{placement}"
    _against_one_and_ref(served, name, (
        "e_reseed", "e_pushpull1", "e_push0b", "promote", "hello", "replay",
        "pushpull0", "read"))
    for r in served["ranks"][name]["ranks"]:
        _same_rows(r, served["one"][name]["final"], "two-rank spare", True)
        _same_rows(r, served["ref"][name]["final"], "vs ref", False)
    r0, r1 = served["ranks"][name]["ranks"]
    assert r0["role"] == "primary"
    assert r1["by_op"] == r0["by_op"]
    assert r0["by_op"]["evict"] == 1 and r0["by_op"]["meta"] == 1
    assert r0["by_op"]["adopt"] == len(SHAPES)


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_final_rows_every_rank_alike(served, placement):
    """Every rank's final rows (parameters, whole optimizer state, stale
    snapshots, apply counts) and counters: bitwise each other and the
    one-process run's, within the bound of the reference's."""
    name = f"A-{placement}"
    ranks = served["ranks"][name]["ranks"]
    for r in ranks:
        _same_rows(r, served["one"][name]["final"], "final", True)
        _same_rows(r, served["ref"][name]["final"], "final vs ref", False)
    _same_rows(ranks[1], ranks[0], "rank 1 vs rank 0", True)


def test_a_store_across_ranks_is_served_through_serve_async(served):
    """``AsyncPSService`` alone on a store across ranks refuses: rank 0
    would serve pushes its other ranks never see."""
    probe = served["ranks"]["A-replicated"]["ranks"][0]["probe"]
    assert "serve_async" in probe


# -- apart from the group -----------------------------------------------------------


#: leaves that 3 and 4 ranks both cut under 'sharded', and a whole one
K_SHAPES = {"a/w": (12, 8), "b/w": (24,), "d/b": (5,)}


@pytest.mark.parametrize("k", (3, 4))
def test_served_push_at_k_ranks_is_bitwise_one_process(tmp_path, k):
    """k ranks, 'sharded': a served push is the worker's gradient as it
    came, each rank stepping its blocks, bitwise one process. A mean over
    the ranks of k copies of it would not be at k = 3 (``3g`` rounds and
    ``3g / 3`` need not be ``g``); at k = 4 a sum of four copies in ring
    order lands on ``4g`` exactly, so there only the served path's
    equality shows."""
    params = _tree(1, shapes=K_SHAPES)
    grads = [_tree(200 + i, 0.1, shapes=K_SHAPES) for i in range(4)]
    ctl = tmp_path / "ctl"
    ctl.mkdir()
    run = torch_ranks.start_ranks(k, [("served", dict(
        params=params, optimizer="sgd", opt_kw={"learning_rate": 0.1},
        placement="sharded", ctl=str(ctl), name="K"))], tmp_path,
        init=INIT)

    def drive(port):
        d = _Drive()
        try:
            d.req("pull0", port, tv.PULL, 0)
            for i in range(4):
                d.req(f"push{i}", port, tv.PUSH_PULL, i % 2, grads[i])
        finally:
            d.close()
        return d.replies

    try:
        got = drive(_wait_port(ctl / "K.port", run))
    finally:
        (ctl / "K.done").write_text("done")
    results = [r[0] for r in run.finish(wall_s=120)]
    ps_tpu_torch.init(backend="cuda", device="cpu", **INIT)
    try:
        st = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=0.1,
                                  mode="async")
        st.init(_like(params))
        svc = serve_async(st)
        try:
            want = drive(svc.port)
        finally:
            svc.stop()
        final = _rows(st._engine)
    finally:
        ps_tpu_torch.shutdown()
    for tag, reply in want.items():
        _same_reply(got[tag], reply, tag, True)
    for r in results:
        _same_rows(r, final, f"{k} ranks", True)
        assert r["by_op"] == results[0]["by_op"]
    if k == 3:
        g = torch.from_numpy(grads[0]["a/w"])
        assert not torch.equal(((g + g) + g) / 3, g)


@pytest.mark.parametrize("sig", ("SIGKILL", "SIGSTOP"))
def test_lost_follower_is_a_typed_failure_not_a_hang(tmp_path, sig):
    """Rank 1 dies mid-run (SIGKILL; 'sharded', whose applies all-gather)
    or stops (SIGSTOP; 'replicated', where rank 0 never waits for it and
    its sockets stay open): rank 0's service stops serving, from its
    next op or collective raising, or from the heartbeat detector's
    WorkerFailureError, and the worker's next cycle raises
    ServerFailureError: within the heartbeat timeout of a death, within
    it plus the detector's poll of a stop."""
    ctl = tmp_path / "ctl"
    ctl.mkdir()
    hb_timeout_ms = 3000
    init = dict(INIT, heartbeat_base_port=torch_ranks.free_port(),
                heartbeat_timeout_ms=hb_timeout_ms,
                heartbeat_interval_ms=50)
    placement = "sharded" if sig == "SIGKILL" else "replicated"
    run = torch_ranks.start_ranks(2, [("served_kill", dict(
        params=PARAMS, ctl=str(ctl), victim=1, placement=placement,
        sig=sig))], tmp_path, init=init)
    try:
        port = _wait_port(ctl / "served.port", run)
        ps_tpu_torch.init(backend="cuda", device="cpu", **INIT)
        try:
            w = connect_async(f"127.0.0.1:{port}", 0, _like(PARAMS))
            try:
                w.pull_all()
                for i in range(3):
                    w.push_pull(_like(GRADS[i]))
                (ctl / "kill").write_text("kill")
                t0 = time.monotonic()
                with pytest.raises(ServerFailureError):
                    while time.monotonic() - t0 < 60:
                        w.push_pull(_like(GRADS[3]))
                        time.sleep(0.02)
                elapsed = time.monotonic() - t0
            finally:
                try:
                    w.close()
                except Exception:
                    pass
        finally:
            ps_tpu_torch.shutdown()
    finally:
        (ctl / "kill").write_text("kill")
        (ctl / "done").write_text("done")
        if sig == "SIGSTOP" and run.procs[1].poll() is None:
            run.procs[1].kill()
    results = run.finish(wall_s=60, expect_rc={1: -9})
    bound = hb_timeout_ms / 1e3 + (0 if sig == "SIGKILL" else 2.0)
    assert elapsed < bound, elapsed
    lost = results[0][0]
    assert lost["error"] != "None" and lost["killed"], lost
    if sig == "SIGSTOP":
        assert "WorkerFailureError" in lost["error"], lost


def test_an_adam_row_crosses_the_wire_into_one_process():
    """An adam row exported by one port engine, carried in a van frame
    (which holds its 0-dim ``count`` as shape ``(1,)``, in both packages)
    and adopted by another: bitwise the donor's. Before, the recipient
    refused the count's shape, so no adam key could move or re-seed."""
    from ps_tpu_torch.elastic.migrate import decode_row, encode_row

    ps_tpu_torch.init(backend="cuda", device="cpu", **INIT)
    try:
        donor = _port_store(PARAMS, "sharded")
        donor.push_all(_like(GRADS[0]), worker=0)
        rows = donor._engine.export_keys(sorted(PARAMS))
        recipient = _port_store(SPARE, "sharded")
        for k, r in rows.items():
            t, e = encode_row(k, r["param"], r["state"], r["stale"],
                              r["apply_count"])
            _, _, tensors, extra = tv.decode(tv.encode(tv.OK, 0, t, e))
            assert tensors["s:0/count"].shape == (1,)
            row = decode_row(tensors, extra)
            recipient._engine.adopt_key(k, row["param"], row["state"],
                                        row["stale"], row["apply_count"])
        got = _rows(recipient._engine, sorted(PARAMS))
        want = _rows(donor._engine)
        assert all(recipient._engine._state[k]["count"].dim() == 0
                   for k in PARAMS)
    finally:
        ps_tpu_torch.shutdown()
    for key in ("version", "worker_version", "staleness_hist"):
        got.pop(key), want.pop(key)
    _same_rows(got, want, "adopted", True)
