"""The port's read path (``READ``, NOT_MODIFIED, the native read cache,
replica reads within a staleness bound, the worker's read cache, sparse
row deltas), against the reference's.

- Bytes: for the same committed state and birth stamp (both packages'
  ``freshness.birth_record`` patched to one fixed stamp), the port's
  dense and sparse READ, conditional READ, NOT_MODIFIED and delta
  replies are byte-equal to the reference's services' (the sparse one
  over ``_RefTable``, the R1 shim, given the per-row change stamps of
  ``ps_tpu/kv/sparse.py``), on thread per connection and on the native
  loop; the workers' READ requests are the reference's bytes, ``"cond"``
  last.
- Interop: a port worker reads a reference service, and a reference
  worker a port service, bitwise against their own pulls.
- Behaviour, each case of the reference's ``tests/test_read_path.py``
  that needs neither the aggregator (held in ``test_torch_aggregation.py``)
  nor a tiered table (held in ``test_torch_tiered.py``), against the
  port's services: a native hit bitwise its pump miss, the
  race drill, per-key invalidation, the cache budget, replica reads
  within the bound and the fallback from a frozen backup, the worker's
  cache until a version bump and its NOT_MODIFIED revalidation,
  coalescing, and a delta merge bitwise a full read. Tolerance: bitwise
  everywhere (a read copies committed bytes).
"""

import threading
import time

import numpy as np
import pytest
import torch

import ps_tpu_torch
from ps_tpu_torch.backends.remote_async import (
    AsyncPSService,
    connect_async,
    shard_tree,
)
from ps_tpu_torch.backends.remote_sparse import (
    SparsePSService,
    connect_sparse,
)
from ps_tpu_torch.control import tensor_van as tv
from ps_tpu_torch.kv.sparse import SparseEmbedding
from ps_tpu_torch.obs import freshness
from tests.test_torch_remote_sparse import _RefTable

#: the birth both packages stamp in the byte-parity cases
FIXED_BIRTH = {"birth": 1700000000.25, "bmono": 12.5, "bpid": "fixed.0"}
LOOP = pytest.mark.parametrize("native_loop", [False, True],
                               ids=["threads", "loop"])


@pytest.fixture(autouse=True)
def _port():
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()
    ps_tpu_torch.init(backend="cuda", mode="async", num_workers=2,
                      dc_lambda=0.0, device="cpu")
    yield
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()


@pytest.fixture
def ref_async():
    """The reference initialized for its async services (jax on the
    CPU)."""
    import ps_tpu

    ps_tpu.init(backend="tpu", mode="async", num_workers=2, dc_lambda=0.0)
    yield ps_tpu
    ps_tpu.shutdown()


@pytest.fixture
def fixed_birth(monkeypatch):
    from ps_tpu.obs import freshness as ref_freshness

    def stamp(wall=None, mono=None):
        return dict(FIXED_BIRTH)

    monkeypatch.setattr(ref_freshness, "birth_record", stamp)
    monkeypatch.setattr(freshness, "birth_record", stamp)


def _params():
    return {"a/w": torch.zeros(16, 8), "b/w": torch.ones(32)}


def _grad(x: float):
    return {"a/w": torch.full((16, 8), x), "b/w": torch.full((32,), x)}


def _host(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _svc(**kw):
    st = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=0.5,
                              mode="async")
    st.init(_params())
    return AsyncPSService(st, **kw)


def _ref_svc(ps_tpu, **kw):
    import jax.numpy as jnp
    from ps_tpu.backends.remote_async import AsyncPSService as RefService

    st = ps_tpu.KVStore(optimizer="sgd", learning_rate=0.5, mode="async")
    st.init({k: jnp.asarray(v) for k, v in _host(_params()).items()})
    return RefService(st, bind="127.0.0.1", **kw)


def _table(rows=64, dim=8, seed=0):
    return (np.random.default_rng(seed)
            .normal(0, 0.01, (rows, dim)).astype(np.float32))


def _emb(rows=64, dim=8, seed=0):
    emb = SparseEmbedding(rows, dim, optimizer="sgd", learning_rate=0.5)
    emb.init(_table(rows, dim, seed))
    return emb


class _RefTableRV(_RefTable):
    """The R1 shim with the per-row change stamps of the reference's
    ``SparseEmbedding`` (``ps_tpu/kv/sparse.py:345``): every real row a
    push touches carries the post-increment push count."""

    def __init__(self, init, optimizer, lr=0.5):
        super().__init__(init, optimizer, lr=lr)
        self.row_version = np.zeros((self.num_rows,), np.int64)

    def push(self, ids, grads):
        super().push(ids, grads)
        ids = np.asarray(ids, np.int64).reshape(-1)
        self.row_version[ids[(ids >= 0) & (ids < self.num_rows)]] = \
            self.push_count


def _raw_read(port, payload=None):
    ch = tv.Channel.connect("127.0.0.1", port)
    try:
        return bytes(ch.request(payload or tv.encode(tv.READ, 0, None)))
    finally:
        ch.close()


def _raw_push(port, kind, tensors, extra=None):
    ch = tv.Channel.connect("127.0.0.1", port)
    try:
        got, _, _, ex = tv.decode(ch.request(tv.encode(kind, 0, tensors,
                                                        extra)))
        assert got == tv.OK, ex
    finally:
        ch.close()


def _cache_settled(svc, pred, timeout=3.0):
    """Wait out the pump's stats sync (about once a second)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        cs = svc._nloop.cache_stats()
        if pred(cs):
            return cs
        time.sleep(0.02)
    return svc._nloop.cache_stats()


def _cond(v):
    return tv.encode(tv.READ, 0, None, extra={"cond": int(v)})


# -- bytes against the reference -------------------------------------------------


@LOOP
def test_dense_replies_byte_equal_the_references(ref_async, fixed_birth,
                                                 native_loop):
    """Never applied (no birth), then after the same push: the full READ,
    the NOT_MODIFIED at the current version and the full reply to a
    lagging cond are the reference's bytes; on the loop the native hit
    repeats them."""
    ref = _ref_svc(ref_async, native_loop=native_loop)
    port = _svc(native_loop=native_loop)
    try:
        def both(payload=None):
            a = [_raw_read(s.port, payload) for s in (ref, port)]
            assert a[0] == a[1]
            if native_loop:  # the hit echoes the published miss
                assert _raw_read(port.port, payload) == a[1]
            return a[1]

        full0 = both()
        assert tv.decode(memoryview(full0))[3] == {"version": 0}
        nm0 = both(_cond(0))
        assert tv.decode(memoryview(nm0))[0] == tv.NOT_MODIFIED
        for s in (ref, port):
            _raw_push(s.port, tv.PUSH, _host(_grad(0.25)))
        full1 = both()
        kind, _, tensors, extra = tv.decode(memoryview(full1))
        assert kind == tv.OK and extra == {"version": 1, **FIXED_BIRTH}
        np.testing.assert_array_equal(np.asarray(tensors["b/w"]),
                                      np.full(32, 0.875, np.float32))
        nm1 = both(_cond(1))
        assert tv.decode(memoryview(nm1))[3] == {"version": 1,
                                                 **FIXED_BIRTH}
        assert both(_cond(5)) == nm1  # any cond at or above the version
        assert both(_cond(0)) == full1  # a lagging cond: the full reply
        assert port.transport.read_not_modified == \
            ref.transport.read_not_modified
    finally:
        ref.stop()
        port.stop()


@LOOP
def test_sparse_replies_byte_equal_the_references(fixed_birth, native_loop):
    """Full rows, a delta (only the rows whose change stamp passed the
    caller's version, duplicates and an unchanged table included) and a
    NOT_MODIFIED are the reference's bytes, its service over the R1 shim
    with change stamps."""
    from ps_tpu.backends.remote_sparse import SparsePSService as RefService

    ref = RefService({"deep": _RefTableRV(_table(), "sgd"),
                      "wide": _RefTableRV(_table(64, 1, 1), "sgd")},
                     native_loop=native_loop)
    port = SparsePSService({"deep": _emb(), "wide": _emb(64, 1, 1)},
                           native_loop=native_loop)
    try:
        def both(payload):
            a = [_raw_read(s.port, payload) for s in (ref, port)]
            assert a[0] == a[1]
            return a[1]

        ids = {"deep/ids": np.array([3, 9, 3, 11, 40], np.int32),
               "wide/ids": np.array([1, 2], np.int32)}
        full = both(tv.encode(tv.READ, 0, ids))
        assert tv.decode(memoryview(full))[3]["births"] == {}
        for s in (ref, port):
            _raw_push(s.port, tv.ROW_PUSH, {
                "deep/ids": np.array([9, 50], np.int32),
                "deep/grads": np.full((2, 8), 0.25, np.float32)})

        def cond(deep, wide):
            return tv.encode(tv.READ, 0, ids, extra={
                "conds": {"deep": deep, "wide": wide},
                "cond": deep + wide})

        delta = both(cond(0, 0))
        kind, _, tensors, extra = tv.decode(memoryview(delta))
        assert kind == tv.OK and extra["delta"] == 1
        assert sorted(tensors) == ["deep/dids", "deep/drows"]
        np.testing.assert_array_equal(np.asarray(tensors["deep/dids"]), [9])
        assert extra["births"] == {"deep": [FIXED_BIRTH["birth"],
                                            FIXED_BIRTH["bmono"],
                                            FIXED_BIRTH["bpid"]]}
        nm = both(cond(1, 0))
        assert tv.decode(memoryview(nm))[0] == tv.NOT_MODIFIED
        both(tv.encode(tv.READ, 0, ids))  # full again, after the push
        both(tv.encode(tv.READ, 0, ids, extra={"conds": {"deep": 0},
                                               "cond": 0}))  # mixed
        assert port.transport.read_delta_rows == \
            ref.transport.read_delta_rows == 2
    finally:
        ref.stop()
        port.stop()


def test_read_requests_equal_the_references(ref_async):
    """The READ frames the port's workers send are the reference
    workers': worker id 0, no extra on a first read, ``{"cond": v}`` on a
    revalidation, and ``{"conds": {...}, "cond": sum}`` with ``"cond"``
    last (the native loop finds the version floor by its last
    occurrence in the request's tail)."""
    import jax.numpy as jnp
    from ps_tpu.backends.remote_async import connect_async as ref_connect
    from ps_tpu.backends.remote_sparse import connect_sparse as ref_sparse

    svc = _svc()
    ssvc = SparsePSService({"deep": _emb(), "wide": _emb(64, 1, 1)})
    try:
        sent = {"port": [], "ref": []}

        def record_port(w):
            orig = w._read_request

            def wrapped(i, addr, payload):
                sent["port"].append(bytes(payload))
                return orig(i, addr, payload)
            w._read_request = wrapped

        def record_ref(w):  # the reference asks its channel directly
            orig = w._read_channel

            def wrapped(*a):
                ch = orig(*a)

                class Rec:
                    def request(self, payload):
                        sent["ref"].append(bytes(payload))
                        return ch.request(payload)
                return Rec()
            w._read_channel = wrapped

        pw = connect_async(f"127.0.0.1:{svc.port}", 0, _params(),
                           pull_cache=True)
        rw = ref_connect(f"127.0.0.1:{svc.port}", 1,
                         {k: jnp.asarray(v) for k, v in
                          _host(_params()).items()}, pull_cache=True)
        for w, record in ((pw, record_port), (rw, record_ref)):
            record(w)
            w.read_all()
            w.versions[0] += 1  # a lag signal: the next read revalidates
            w.read_all()
            w.close()
        assert sent["port"] == sent["ref"]
        assert sent["port"] == [tv.encode(tv.READ, 0, None), _cond(0)]

        ids = {"deep": np.array([5, 1, 5], np.int32),
               "wide": np.array([7], np.int32)}
        spec = {"deep": (64, 8), "wide": (64, 1)}
        got = {}
        for name, w in (("port", connect_sparse(f"127.0.0.1:{ssvc.port}",
                                                0, spec)),
                        ("ref", ref_sparse(f"127.0.0.1:{ssvc.port}", 1,
                                           spec))):
            frames = []
            fan = "_read_fanout" if name == "port" else "_fanout"
            orig = getattr(w, fan)

            def wrapped(payloads, *rest, orig=orig, frames=frames):
                frames.extend(bytes(p) for p in payloads.values())
                return orig(payloads, *rest)
            setattr(w, fan, wrapped)
            r1, r2 = w.read_rows(ids), w.read_rows(ids)
            rows = [np.asarray(r1[n]) for n in ids]
            for n, a in zip(ids, rows):
                np.testing.assert_array_equal(a, np.asarray(r2[n]))
            got[name] = (frames, rows)
            w.close()
        assert got["port"][0] == got["ref"][0]
        first, second = got["port"][0]
        assert first == tv.encode(tv.READ, 0, {"deep/ids": ids["deep"],
                                               "wide/ids": ids["wide"]})
        tail = second[-4096:]
        assert tail.rfind(b'"cond":') > tail.rfind(b'"conds":') >= 0
        for a, b in zip(got["port"][1], got["ref"][1]):
            np.testing.assert_array_equal(a, b)
    finally:
        svc.stop()
        ssvc.stop()


def test_port_worker_reads_a_reference_service(ref_async):
    ref = _ref_svc(ref_async)
    try:
        w = connect_async(f"127.0.0.1:{ref.port}", 0, _params(),
                          pull_cache=True)
        w.push_all(_grad(0.25))
        read, version = w.read_all_versioned()
        assert version == 1
        pulled = w.pull_all()
        for k in pulled:
            assert read[k].device == pulled[k].device
            np.testing.assert_array_equal(read[k].numpy(), pulled[k].numpy())
        w.versions[0] += 1  # revalidation: the reference answers NM
        again = w.read_all()
        assert ref.transport.read_not_modified == 1
        for k in pulled:
            np.testing.assert_array_equal(again[k].numpy(),
                                          pulled[k].numpy())
        w.close()
    finally:
        ref.stop()


def test_reference_worker_reads_a_port_service(ref_async):
    import jax.numpy as jnp
    from ps_tpu.backends.remote_async import connect_async as ref_connect

    svc = _svc(native_loop=True)
    try:
        w = ref_connect(f"127.0.0.1:{svc.port}", 0,
                        {k: jnp.asarray(v) for k, v in
                         _host(_params()).items()}, pull_cache=True)
        w.push_all({k: jnp.asarray(v) for k, v in _host(_grad(0.5)).items()})
        read = w.read_all()
        pulled = w.pull_all()
        for k in pulled:
            np.testing.assert_array_equal(np.asarray(read[k]),
                                          np.asarray(pulled[k]))
        w.versions[0] += 1
        w.read_all()
        assert svc.transport.read_not_modified == 1
        w.close()
    finally:
        svc.stop()


def test_sparse_interop_reads_both_ways():
    """A port worker's ``read_rows`` against the reference's service (over
    the shim), a reference worker's against the port's, each bitwise its
    own pull, deltas merged included."""
    from ps_tpu.backends.remote_sparse import SparsePSService as RefService
    from ps_tpu.backends.remote_sparse import connect_sparse as ref_sparse

    spec = {"deep": (64, 8)}
    ids = np.array([3, 9, 3, 11, 40], np.int32)
    ref = RefService({"deep": _RefTableRV(_table(), "sgd")})
    port = SparsePSService({"deep": _emb()}, native_loop=True)
    try:
        for connect, svc in ((connect_sparse, ref), (ref_sparse, port)):
            w = connect(f"127.0.0.1:{svc.port}", 0, spec)
            for step in range(3):
                r = np.asarray(w.read_rows({"deep": ids})["deep"])
                np.testing.assert_array_equal(
                    r, np.asarray(w.pull({"deep": ids})["deep"]))
                w.push({"deep": (np.array([9 + step], np.int32),
                                 np.full((1, 8), 0.5, np.float32))})
            assert svc.transport.read_delta_rows >= 1
            w.close()
    finally:
        ref.stop()
        port.stop()


# -- bitwise parity of the tiers ----------------------------------------------------


def test_dense_native_hit_bitwise_equals_pump_miss():
    svc = _svc(native_loop=True)
    try:
        miss = _raw_read(svc.port)   # the pump; publishes
        hit = _raw_read(svc.port)    # the loop; echoes the publish
        assert hit == miss
        cs = _cache_settled(svc, lambda c: c["hits"] >= 1)
        assert cs["hits"] >= 1 and cs["puts"] >= 1, cs
        # thread per connection encodes the same bytes for the same state
        twin = _svc(native_loop=False)
        try:
            assert _raw_read(twin.port) == miss
        finally:
            twin.stop()
    finally:
        svc.stop()


def test_sparse_native_hit_bitwise_equals_pump_miss():
    svc = SparsePSService({"deep": _emb()}, native_loop=True)
    try:
        ids = np.array([3, 9, 11], np.int32)
        payload = tv.encode(tv.READ, 0, {"deep/ids": ids})
        miss = _raw_read(svc.port, payload)
        hit = _raw_read(svc.port, payload)
        assert hit == miss
        cs = _cache_settled(svc, lambda c: c["hits"] >= 1)
        assert cs["hits"] >= 1, cs
        w = connect_sparse(f"127.0.0.1:{svc.port}", 0, {"deep": (64, 8)})
        try:
            read = w.read_rows({"deep": ids})
            pulled = w.pull({"deep": ids})
            assert torch.equal(read["deep"], pulled["deep"])
            w.push({"deep": (ids, np.full((3, 8), 0.5, np.float32))})
            read2 = w.read_rows({"deep": ids})
            assert not torch.equal(read2["deep"], read["deep"])
            assert torch.equal(read2["deep"], w.pull({"deep": ids})["deep"])
        finally:
            w.close()
    finally:
        svc.stop()


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_threaded_and_loop_reads_serve_the_same_bytes(fixed_birth, sparse):
    """Thread per connection and the loop's pump serve one READ (full,
    conditional, NOT_MODIFIED) with the same bytes, before and after an
    apply."""
    if sparse:
        svcs = [SparsePSService({"deep": _emb()}, native_loop=loop)
                for loop in (False, True)]
        ids = {"deep/ids": np.array([4, 2, 4], np.int32)}
        reqs = [tv.encode(tv.READ, 0, ids)] + [
            tv.encode(tv.READ, 0, ids, extra={"conds": {"deep": v},
                                              "cond": v}) for v in (0, 1)]
        push = (tv.ROW_PUSH, {"deep/ids": np.array([2], np.int32),
                              "deep/grads": np.ones((1, 8), np.float32)})
    else:
        svcs = [_svc(native_loop=loop) for loop in (False, True)]
        reqs = [tv.encode(tv.READ, 0, None), _cond(0), _cond(1)]
        push = (tv.PUSH, _host(_grad(0.5)))
    try:
        for _ in range(2):
            for req in reqs:
                got = [_raw_read(s.port, req) for s in svcs]
                assert got[0] == got[1]
                assert _raw_read(svcs[1].port, req) == got[1]  # a hit
            for s in svcs:
                _raw_push(s.port, *push)
    finally:
        for s in svcs:
            s.stop()


# -- invalidation on apply ----------------------------------------------------------


def test_invalidation_on_apply_race_drill():
    """A reader hammering READs while a pusher commits: every read's
    version is monotone, and after the pusher's last acked push a fresh
    READ carries at least that version; a cached reply surviving an apply
    would fail both."""
    svc = _svc(native_loop=True)
    pusher = connect_async(f"127.0.0.1:{svc.port}", 0, _params())
    stop = threading.Event()
    seen, errs = [], []

    def reader():
        ch = tv.Channel.connect("127.0.0.1", svc.port)
        payload = tv.encode(tv.READ, 0, None)
        try:
            last = -1
            while not stop.is_set():
                kind, _, tensors, extra = tv.decode(ch.request(payload))
                assert kind == tv.OK
                v = int(extra["version"])
                if v < last:
                    errs.append(f"version went backward: {last} -> {v}")
                    return
                # the bytes are the version's: b/w is 1 - 0.5 * sum(grads)
                want = 1.0 - 0.5 * sum(0.01 * (i + 1) for i in range(v))
                if abs(float(np.asarray(tensors["b/w"])[0]) - want) > 1e-5:
                    errs.append(f"version {v} carries another state")
                    return
                last = v
                seen.append(v)
        except tv.VanError:
            pass
        finally:
            ch.close()

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        for i in range(25):
            pusher.push_all(_grad(0.01 * (i + 1)))
        final = svc._engine.version
        kind, _, _, extra = tv.decode(memoryview(_raw_read(svc.port)))
        assert kind == tv.OK and int(extra["version"]) >= final
    finally:
        stop.set()
        t.join(timeout=10)
        pusher.close()
        svc.stop()
    assert not errs, errs
    assert seen and max(seen) >= 1  # the race raced


def test_cache_disabled_budget_zero_still_serves(monkeypatch):
    monkeypatch.setenv("PS_NATIVE_READ_CACHE_BYTES", "0")
    svc = _svc(native_loop=True)
    try:
        assert not svc._native_read_cache
        r1 = _raw_read(svc.port)
        r2 = _raw_read(svc.port)
        assert r1 == r2  # the pump both times, the same bytes
        assert svc._nloop.cache_stats()["puts"] == 0
    finally:
        svc.stop()


def test_an_entry_over_the_budget_is_refused_and_counted(monkeypatch):
    """A reply larger than ``PS_NATIVE_READ_CACHE_BYTES`` is never
    cached: every read goes to the pump, the same bytes, and the loop
    counts each refused put."""
    monkeypatch.setenv("PS_NATIVE_READ_CACHE_BYTES", "512")
    svc = _svc(native_loop=True)
    try:
        assert svc._native_read_cache
        replies = [_raw_read(svc.port) for _ in range(3)]
        assert len(replies[0]) > 512 and len(set(replies)) == 1
        cs = _cache_settled(svc, lambda c: c["rejects"] >= 3)
        assert cs["rejects"] >= 3 and cs["hits"] == 0, cs
        assert cs["entries"] == 0 and svc.transport.reads_served == 3
    finally:
        svc.stop()


def test_set_read_cache_bytes_switches_the_cache_while_serving():
    """The budget set while serving: 0 drops every entry and sends READs
    to the pump; a push while it is off invalidates nothing, so turning
    it on again raises the publish floor, and the first READ after is
    the post-push bytes from the pump, published and then hit. Off the
    loop there is no cache to set."""
    svc = _svc(native_loop=True)
    w = connect_async(f"127.0.0.1:{svc.port}", 0, _params())
    try:
        old = _raw_read(svc.port)
        assert _raw_read(svc.port) == old
        cs = _cache_settled(svc, lambda c: c["hits"] >= 1)
        assert cs["hits"] >= 1 and cs["entries"] >= 1, cs
        svc.set_read_cache_bytes(0)
        assert not svc._native_read_cache
        assert svc._nloop.cache_stats()["entries"] == 0
        w.push_all(_grad(0.25))
        new = _raw_read(svc.port)
        assert new != old and _raw_read(svc.port) == new
        floor = _cache_settled(svc, lambda c: True)["floor"]
        svc.set_read_cache_bytes(1 << 20)
        assert svc._native_read_cache
        cs = _cache_settled(svc, lambda c: c["floor"] > floor)
        assert cs["floor"] > floor, cs
        hits = cs["hits"]
        assert _raw_read(svc.port) == new  # the pump; publishes
        assert _raw_read(svc.port) == new  # the loop
        cs = _cache_settled(svc, lambda c: c["hits"] > hits)
        assert cs["hits"] == hits + 1, cs
        with pytest.raises(ValueError):
            svc.set_read_cache_bytes(-1)
    finally:
        w.close()
        svc.stop()
    twin = _svc(native_loop=False)
    try:
        with pytest.raises(RuntimeError, match="native_loop=True"):
            twin.set_read_cache_bytes(1 << 20)
    finally:
        twin.stop()


def test_sparse_per_key_invalidation_keeps_disjoint_sets_native():
    """A row apply raises the floor for everyone but drops only the
    cached id-sets it touches: a disjoint hot set keeps serving from the
    cache while the touched set's entry drops and republishes the
    post-apply rows."""
    svc = SparsePSService({"deep": _emb()}, native_loop=True)
    hot = tv.encode(tv.READ, 0, {"deep/ids": np.array([1, 2, 3], np.int32)})
    cold = tv.encode(tv.READ, 0, {"deep/ids": np.array([40, 41], np.int32)})
    try:
        m_hot, m_cold = _raw_read(svc.port, hot), _raw_read(svc.port, cold)
        assert _raw_read(svc.port, hot) == m_hot    # both cached now
        assert _raw_read(svc.port, cold) == m_cold
        cs0 = _cache_settled(svc, lambda c: c["hits"] >= 2)
        w = connect_sparse(f"127.0.0.1:{svc.port}", 0, {"deep": (64, 8)})
        try:
            for i in range(4):
                w.push({"deep": (np.array([2], np.int32),
                                 np.full((1, 8), 0.1 * (i + 1),
                                         np.float32))})
                assert _raw_read(svc.port, cold) == m_cold
            fresh = _raw_read(svc.port, hot)
            assert fresh != m_hot
            rows = np.asarray(tv.decode(memoryview(fresh))[2]["deep/rows"])
            np.testing.assert_array_equal(
                rows, w.pull({"deep": np.array([1, 2, 3], np.int32)})
                ["deep"].numpy())
        finally:
            w.close()
        cs1 = _cache_settled(
            svc, lambda c: c["hits"] >= cs0["hits"] + 4
            and c["puts"] >= cs0["puts"] + 1)
        assert cs1["hits"] >= cs0["hits"] + 4, (cs0, cs1)
        assert cs1["puts"] == cs0["puts"] + 1  # only the hot set's
        assert cs1["invalidations"] >= cs0["invalidations"] + 4
        assert cs1["floor"] >= cs0["floor"] + 4
    finally:
        svc.stop()


def test_checkpoint_resume_promotion_and_fencing_drop_every_read():
    """The structural changes invalidate untagged: a checkpoint's resume
    and a promotion drop every cached READ, and a fenced zombie refuses
    READs with the typed retryable reply."""
    svc = _svc(native_loop=True)
    try:
        _raw_read(svc.port)
        assert _cache_settled(svc, lambda c: c["entries"] == 1)["entries"]
        w = connect_async(f"127.0.0.1:{svc.port}", 0, _params())
        tok = tv.decode(w._chs[0].request(tv.encode(
            tv.CHECKPOINT, 0, None, extra={"phase": "pause"})))[3]["token"]
        tv.decode(w._chs[0].request(tv.encode(
            tv.CHECKPOINT, 0, None, extra={"phase": "resume",
                                           "token": tok})))
        assert svc._nloop.cache_stats()["entries"] == 0
        w.close()
        _raw_read(svc.port)
        svc.role = "backup"
        svc.promote("drill")
        assert svc._nloop.cache_stats()["entries"] == 0
        svc._fence(svc.epoch + 1)
        kind, _, _, extra = tv.decode(memoryview(_raw_read(svc.port)))
        assert kind == tv.ERR and extra["backup"] is True
    finally:
        svc.stop()


# -- replica reads and the staleness bound --------------------------------------------


def test_backup_serves_read_refuses_push():
    back = _svc(backup=True)
    try:
        kind, _, tensors, extra = tv.decode(memoryview(_raw_read(back.port)))
        assert kind == tv.OK and int(extra["version"]) == 0
        assert sorted(tensors) == sorted(_params())
        ch = tv.Channel.connect("127.0.0.1", back.port)
        try:
            kind, _, _, extra = tv.decode(
                ch.request(tv.encode(tv.PUSH, 0, _host(_grad(1.0)))))
            assert kind == tv.ERR and extra.get("backup") is True
        finally:
            ch.close()
    finally:
        back.stop()


@LOOP
def test_replica_reads_spread_within_bound(native_loop):
    prim = _svc(native_loop=native_loop)
    back = _svc(backup=True)
    prim.attach_backup("127.0.0.1", back.port, ack="sync")
    uri = f"127.0.0.1:{prim.port}|127.0.0.1:{back.port}"
    w = connect_async(uri, 0, _params(), read_staleness=0)
    try:
        w.push_all(_grad(0.5))
        trees = [w.read_all() for _ in range(6)]
        # sync ack: the backup is never behind an acked push, so even
        # bound 0 lets it serve, and the rotation used it
        assert w.transport.reads_replica >= 2
        assert w.transport.read_fallbacks == 0
        assert back.transport.reads_served >= 2
        for t in trees:
            np.testing.assert_array_equal(t["b/w"].numpy(),
                                          np.full(32, 0.75, np.float32))
    finally:
        w.close()
        prim.stop()
        back.stop()


def test_staleness_bound_falls_back_to_primary():
    """A backup frozen at version 0 (never attached) against a primary at
    4: a bound-1 worker routes every read to the primary; a huge bound
    lets the frozen replica serve its old state."""
    prim = _svc()
    stale = _svc(backup=True)
    uri = f"127.0.0.1:{prim.port}|127.0.0.1:{stale.port}"
    w = connect_async(uri, 0, _params(), read_staleness=1)
    try:
        for _ in range(4):
            w.push_all(_grad(0.25))
        for _ in range(6):
            tree = w.read_all()
            assert float(tree["b/w"][0]) != 1.0  # never the frozen state
        assert w.transport.reads_replica == 0
        assert w.transport.read_fallbacks >= 3
    finally:
        w.close()
    w2 = connect_async(uri, 1, _params(), read_staleness=10_000)
    try:
        for _ in range(6):
            w2.read_all()
        assert w2.transport.reads_replica >= 2
    finally:
        w2.close()
        prim.stop()
        stale.stop()


def test_sparse_replica_reads_within_bound_and_frozen_fallback():
    """The sparse worker reads a ``p|b`` set as the dense one does: a
    sync-acked backup serves at bound 0 (its rows bitwise the primary's),
    and a frozen one at bound 1 serves nothing, every read it was asked
    falling back to the primary."""
    spec = {"deep": (64, 8)}
    ids = np.array([3, 9, 11, 3], np.int32)
    prim = SparsePSService({"deep": _emb()}, native_loop=True)
    back = SparsePSService({"deep": _emb()}, backup=True)
    frozen = SparsePSService({"deep": _emb()}, backup=True)
    prim.attach_backup("127.0.0.1", back.port, ack="sync")
    try:
        pusher = connect_sparse(f"127.0.0.1:{prim.port}", 1, spec)
        w = connect_sparse(f"127.0.0.1:{prim.port}|127.0.0.1:{back.port}", 0,
                           spec, read_staleness=0)
        for step in range(4):
            pusher.push({"deep": (np.array([9, 30 + step], np.int32),
                                  np.full((2, 8), 0.25, np.float32))})
            r = w.read_rows({"deep": ids})["deep"].numpy()
            np.testing.assert_array_equal(
                r, pusher.pull({"deep": ids})["deep"].numpy())
        assert w.transport.reads_replica >= 1
        assert w.transport.read_fallbacks == 0
        assert back.transport.read_delta_rows >= 1 or \
            back.transport.read_not_modified >= 1
        w.close()
        w2 = connect_sparse(f"127.0.0.1:{prim.port}|127.0.0.1:{frozen.port}",
                            0, spec, read_staleness=1)
        for _ in range(6):
            r = w2.read_rows({"deep": ids})["deep"].numpy()
            np.testing.assert_array_equal(
                r, pusher.pull({"deep": ids})["deep"].numpy())
        assert w2.transport.reads_replica == 0
        assert w2.transport.read_fallbacks == 3  # the rotation's half
        assert frozen.transport.reads_served == 3
        w2.close()
        pusher.close()
    finally:
        prim.stop()
        back.stop()
        frozen.stop()


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_each_shard_rotates_over_its_own_replica_set(sparse):
    """Two shards of a primary and a sync-acked backup each, read 4 times
    at bound 0: every member serves 2 reads. A rotation counter shared by
    the shards would start every read of shard 0 at its primary and every
    read of shard 1 at its backup."""
    prims, backs = [], []
    for s in range(2):
        for backup, group in ((False, prims), (True, backs)):
            if sparse:
                emb = SparseEmbedding(32, 8, optimizer="sgd",
                                      learning_rate=0.5)
                emb.init(_table(64, 8)[32 * s: 32 * (s + 1)])
                group.append(SparsePSService(
                    {"deep": emb}, shard=s, num_shards=2,
                    total_rows={"deep": 64}, backup=backup))
            else:
                st = ps_tpu_torch.KVStore(optimizer="sgd", learning_rate=0.5,
                                          mode="async")
                st.init(shard_tree(_params(), s, 2))
                group.append(AsyncPSService(st, shard=s, num_shards=2,
                                            backup=backup))
        prims[s].attach_backup("127.0.0.1", backs[s].port, ack="sync")
    uri = ",".join(f"127.0.0.1:{p.port}|127.0.0.1:{b.port}"
                   for p, b in zip(prims, backs))
    try:
        if sparse:
            w = connect_sparse(uri, 0, {"deep": (64, 8)}, read_staleness=0)
            ids = np.array([3, 40, 9, 60], np.int32)
            want = _table(64, 8)[ids]
            for _ in range(4):
                got = w.read_rows({"deep": ids})["deep"].numpy()
                np.testing.assert_array_equal(got, want)
        else:
            w = connect_async(uri, 0, _params(), read_staleness=0)
            for _ in range(4):
                tree = w.read_all()
                for k, v in _params().items():
                    assert torch.equal(tree[k], v)
        assert w.transport.read_fallbacks == 0
        w.close()
        assert [s.transport.reads_served for s in prims + backs] == [2] * 4
    finally:
        for svc in prims + backs:
            svc.stop()


# -- the worker's cache and coalescing ----------------------------------------------------


def test_worker_cache_hits_until_version_bump():
    svc = _svc()
    w = connect_async(f"127.0.0.1:{svc.port}", 0, _params(), pull_cache=True)
    try:
        t1, t2, t3 = w.read_all(), w.read_all(), w.read_all()
        assert w.transport.read_wire == 1
        assert w.transport.read_cache_hits == 2
        assert torch.equal(t1["a/w"], t3["a/w"])
        t2["a/w"].add_(1.0)  # the caller's tensors are its own
        assert torch.equal(w.read_all()["a/w"], t1["a/w"])
        w.push_all(_grad(1.0))  # the ack moves versions[0]: invalidated
        t4 = w.read_all()
        assert w.transport.read_wire == 2
        assert not torch.equal(t4["b/w"], t1["b/w"])
    finally:
        w.close()
        svc.stop()


def test_version_watch_invalidates_pure_reader_cache():
    """A pure reader learns of version bumps from its watcher's
    REPLICA_STATE polls, so its cached read goes stale and the next read
    goes to the wire."""
    svc = _svc(native_loop=True)
    uri = f"127.0.0.1:{svc.port}"
    pusher = connect_async(uri, 0, _params())
    reader = connect_async(uri, 1, _params(), pull_cache=True)
    try:
        reader.read_all()
        assert reader.transport.read_wire == 1
        pusher.push_all(_grad(2.0))
        deadline = time.monotonic() + 5.0
        while reader.versions[0] < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert reader.versions[0] >= 1, "the watcher never saw the bump"
        reader.read_all()
        assert reader.transport.read_wire == 2
        assert reader._read_snaps[0]["version"] >= 1
    finally:
        pusher.close()
        reader.close()
        svc.stop()


def test_concurrent_reads_coalesce_into_one_fetch():
    svc = _svc()
    w = connect_async(f"127.0.0.1:{svc.port}", 0, _params())
    orig = svc._read_payload

    def slow_read():
        time.sleep(0.3)
        return orig()

    svc._read_payload = slow_read
    try:
        barrier = threading.Barrier(6)
        errs = []

        def one():
            try:
                barrier.wait(timeout=10)
                w.read_all()
            except BaseException as e:
                errs.append(e)

        ts = [threading.Thread(target=one, daemon=True) for _ in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not errs, errs
        assert w.transport.read_wire <= 2
        assert w.transport.read_coalesced >= 4
    finally:
        svc._read_payload = orig
        w.close()
        svc.stop()


def test_coalesced_waiter_refuses_stale_shared_fetch():
    """A waiter sharing an in-flight fetch holds it to the cache's bound:
    an ack seen while the fetch was in flight makes its snapshot stale for
    the waiter, who fetches again."""
    svc = _svc()
    w = connect_async(f"127.0.0.1:{svc.port}", 0, _params(),
                      read_staleness=0)
    orig_fetch = w._read_fetch
    release, entered = threading.Event(), threading.Event()
    calls = []
    stale_sentinel = {"version": 0, "kv": {}}

    def slow_stale_fetch(i):
        calls.append(i)
        if len(calls) == 1:
            entered.set()
            release.wait(10)
            return stale_sentinel
        return orig_fetch(i)

    w._read_fetch = slow_stale_fetch
    try:
        results = {}
        t1 = threading.Thread(target=lambda: results.update(
            a=w._read_shard(0)), daemon=True)
        t1.start()
        assert entered.wait(10)
        w.versions[0] = 5  # an ack lands while the fetch is in flight
        t2 = threading.Thread(target=lambda: results.update(
            b=w._read_shard(0)), daemon=True)
        t2.start()
        time.sleep(0.2)
        release.set()
        t1.join(timeout=10)
        t2.join(timeout=10)
        assert results["a"] is stale_sentinel
        assert results["b"] is not stale_sentinel
        assert len(calls) == 2
    finally:
        w._read_fetch = orig_fetch
        w.close()
        svc.stop()


# -- knobs -----------------------------------------------------------------------------


def test_read_path_knobs_roundtrip(monkeypatch):
    from ps_tpu_torch.config import Config

    monkeypatch.setenv("PS_READ_STALENESS", "3")
    monkeypatch.setenv("PS_PULL_CACHE", "1")
    monkeypatch.setenv("PS_READ_CONDITIONAL", "0")
    monkeypatch.setenv("PS_NATIVE_READ_CACHE_BYTES", "1048576")
    monkeypatch.setenv("PS_CONNECT_MAX_WAIT_MS", "1200")
    monkeypatch.setenv("PS_AGG_PROBE_MAX_WAIT_MS", "50")
    cfg = Config.from_env()
    assert cfg.read_staleness == 3
    assert cfg.pull_cache is True
    assert cfg.read_conditional is False
    assert cfg.native_read_cache_bytes == 1 << 20
    assert cfg.connect_max_wait_ms == 1200
    assert cfg.agg_probe_max_wait_ms == 50
    with pytest.raises(ValueError):
        Config(read_staleness=-1)
    with pytest.raises(ValueError):
        Config(native_read_cache_bytes=-1)
    with pytest.raises(ValueError):
        Config(connect_max_wait_ms=-1)
    # and the services and workers read them
    svc = _svc()
    w = connect_async(f"127.0.0.1:{svc.port}", 0, _params())
    try:
        assert (w.read_staleness, w.pull_cache, w.read_conditional) == \
            (3, True, False)
    finally:
        w.close()
        svc.stop()


def test_connect_budget_env_bounds_dead_dial(monkeypatch):
    monkeypatch.setenv("PS_CONNECT_MAX_WAIT_MS", "200")
    t0 = time.monotonic()
    with pytest.raises(tv.VanError):
        tv.Channel.connect("127.0.0.1", 1, timeout_ms=200, retries=50)
    assert time.monotonic() - t0 < 5.0


# -- conditional and delta reads ----------------------------------------------------------


def test_dense_conditional_read_not_modified_and_full_parity():
    svc = _svc()
    w = connect_async(f"127.0.0.1:{svc.port}", 0, _params())
    try:
        full = _raw_read(svc.port)
        kind, _, _, extra = tv.decode(memoryview(full))
        assert kind == tv.OK
        v = int(extra["version"])
        nm = _raw_read(svc.port, _cond(v))
        kind, _, tensors, extra = tv.decode(memoryview(nm))
        assert kind == tv.NOT_MODIFIED
        assert not tensors and int(extra["version"]) == v
        assert len(nm) < len(full) / 5  # a handshake, not a payload
        assert svc.transport.read_not_modified >= 1
        w.push_all(_grad(0.5))
        assert _raw_read(svc.port, _cond(v)) == _raw_read(svc.port)
    finally:
        w.close()
        svc.stop()


def test_dense_conditional_native_hit_bitwise_and_cond_counter():
    svc = _svc(native_loop=True)
    try:
        kind, _, _, extra = tv.decode(memoryview(_raw_read(svc.port)))
        v = int(extra["version"])
        miss = _raw_read(svc.port, _cond(v))   # the pump; publishes
        assert tv.decode(memoryview(miss))[0] == tv.NOT_MODIFIED
        assert _raw_read(svc.port, _cond(v)) == miss  # the loop echoes
        assert _raw_read(svc.port, _cond(v + 7)) == miss  # the same floor
        cs = _cache_settled(svc, lambda c: c["cond_hits"] >= 2)
        assert cs["cond_hits"] >= 2, cs
        assert cs["hits"] >= cs["cond_hits"], cs
        deadline = time.monotonic() + 3.0
        while True:  # STATS reads the counters the pump last synced
            st = tv.decode(memoryview(_raw_read(svc.port, tv.encode(
                tv.STATS, 0, None))))[3]
            if st["read"]["native_cond_hits"] >= 2 \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        assert st["read"]["native_cond_hits"] >= 2, st["read"]
        assert st["read"]["nm"] == 1 and st["version"] == 0
    finally:
        svc.stop()


def test_worker_cache_revalidates_with_not_modified():
    svc = _svc()
    w = connect_async(f"127.0.0.1:{svc.port}", 0, _params(), pull_cache=True)
    try:
        t1 = w.read_all()
        wire0 = w.transport.read_wire
        w.versions[0] += 1  # a lag signal, the server unchanged
        t2 = w.read_all()
        assert w.transport.read_wire == wire0 + 1
        assert svc.transport.read_not_modified >= 1
        for k in ("a/w", "b/w"):
            assert torch.equal(t1[k], t2[k])
    finally:
        w.close()
        svc.stop()


def test_lagging_not_modified_refused_by_staleness_bound():
    """A frozen backup answering NOT_MODIFIED to a cond it cannot judge is
    refused by the same bound as a lagging full reply: the read falls
    back to the primary and serves the post-push state."""
    prim = _svc()
    stale = _svc(backup=True)
    uri = f"127.0.0.1:{prim.port}|127.0.0.1:{stale.port}"
    pusher = connect_async(f"127.0.0.1:{prim.port}", 1, _params())
    w = connect_async(uri, 0, _params(), read_staleness=0, pull_cache=True)
    try:
        w.read_all()  # a snapshot at 0; the rotation used start 0
        for _ in range(4):
            pusher.push_all(_grad(0.25))
        deadline = time.monotonic() + 5.0
        while w.versions[0] < 4 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert w.versions[0] >= 4, "the watcher never saw the bump"
        tree, version = w.read_all_versioned()
        assert int(version) >= 4
        assert float(tree["b/w"][0]) != 1.0
        assert w.transport.read_fallbacks >= 1
        assert stale.transport.read_not_modified >= 1
    finally:
        w.close()
        pusher.close()
        prim.stop()
        stale.stop()


def test_sparse_conditional_delta_matches_full_read():
    """A repeat ``read_rows`` of one id-set is a NOT_MODIFIED handshake;
    after a push touching a subset the server ships only those rows, and
    the merge is bitwise the full pull, duplicate ids included."""
    svc = SparsePSService({"deep": _emb()})
    w = connect_sparse(f"127.0.0.1:{svc.port}", 0, {"deep": (64, 8)})
    try:
        ids = np.array([3, 9, 3, 11, 40], np.int32)
        r1 = w.read_rows({"deep": ids})
        pulled0 = w.bytes_pulled
        r2 = w.read_rows({"deep": ids})
        assert torch.equal(r1["deep"], r2["deep"])
        assert svc.transport.read_not_modified >= 1
        assert w.bytes_pulled - pulled0 < 250  # a handshake, not rows
        w.push({"deep": (np.array([9], np.int32),
                         np.full((1, 8), 0.5, np.float32))})
        r3 = w.read_rows({"deep": ids})
        assert svc.transport.read_delta_rows == 1
        assert torch.equal(r3["deep"], w.pull({"deep": ids})["deep"])
        assert torch.equal(r3["deep"][0], r3["deep"][2])
    finally:
        w.close()
        svc.stop()


def test_sparse_conditional_off_knob_restores_full_reads(monkeypatch):
    monkeypatch.setenv("PS_READ_CONDITIONAL", "0")
    svc = SparsePSService({"deep": _emb()})
    w = connect_sparse(f"127.0.0.1:{svc.port}", 0, {"deep": (64, 8)})
    try:
        ids = np.array([3, 9, 11], np.int32)
        r1 = w.read_rows({"deep": ids})
        r2 = w.read_rows({"deep": ids})
        assert torch.equal(r1["deep"], r2["deep"])
        assert not w._read_snaps
        assert svc.transport.read_not_modified == 0
    finally:
        w.close()
        svc.stop()
