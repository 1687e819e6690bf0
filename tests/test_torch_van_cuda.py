"""The van plane's staging through pinned host memory, on the card.

Every CUDA tensor crossing the van is copied to pinned host memory, and
the copy waited for, before its frame is sent; a received tensor is
copied to the card, and waited for, before its frame's buffer is reused.
Both orderings fail silently when wrong, so these tests need an NVIDIA
GPU (the ``cuda`` marker; they skip elsewhere). Run them on the card with
``python -m pytest tests/test_torch_van_cuda.py --noconftest``.

- ``stage_to_host``/``stage_to_device`` round-trip every float and int
  dtype bitwise and refuse bfloat16 with a typed error.
- A server on the card and three workers on the card (threads; one
  serial, two bucketed) do many pulls and push_pulls under each other's
  pushes; every pulled tree equals, bitwise, the tree the server's event
  log gives at that pull when replayed through a one-process server.
- The sparse PS (``backends/remote_sparse.py``): two shard services with
  their tables on the card and three worker threads whose ids and grads
  lie on the card. Pulled rows come back on the card; every applied push
  launched the grouping pass and the apply once a table; the tables and
  every pulled row set equal the apply logs' replay on the card bitwise.
  Numpy ids get CPU rows; a bf16 gradient on the card is refused.
"""

import json
import threading

import numpy as np
import pytest
import torch

import ps_tpu_torch as ps
from ps_tpu_torch.backends.common import stage_to_device, stage_to_host
from ps_tpu_torch.backends.remote_async import AsyncPSService
import test_torch_van_harness as harness  # beside this file (no package)

pytestmark = pytest.mark.cuda

SHAPES = [("a/w", (256, 1024)), ("b/w", (1024, 513)), ("c/b", (777,))]
WORKERS, ROUNDS = 3, 60


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: staging to the card has no CPU "
                    "mode")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _fresh():
    if ps.is_initialized():
        ps.shutdown()
    yield
    if ps.is_initialized():
        ps.shutdown()


def test_staging_round_trips_bitwise(cuda):
    g = torch.Generator().manual_seed(0)
    tree = {
        "f32": torch.randn(300, 7, generator=g),
        "f16": torch.randn(64, generator=g).half(),
        "f64": torch.randn(5, 5, generator=g).double(),
        "i32": torch.randint(-9, 9, (33,), generator=g, dtype=torch.int32),
        "i64": torch.randint(-9, 9, (2, 3), generator=g),
        "empty": torch.zeros(0, 4),
        "strided": torch.randn(8, 6, generator=g).t(),
    }
    host = stage_to_host({k: v.to(cuda) for k, v in tree.items()})
    for k, v in tree.items():
        assert host[k].dtype == v.numpy().dtype
        np.testing.assert_array_equal(host[k], v.contiguous().numpy())
    back = stage_to_device(host, cuda)
    for k, v in tree.items():
        assert back[k].device == cuda and torch.equal(back[k].cpu(), v)
    with pytest.raises(TypeError, match="bfloat16"):
        stage_to_host({"w": torch.ones(3, device=cuda,
                                       dtype=torch.bfloat16)})


def _grads(worker, cycle, cuda):
    rng = np.random.default_rng([worker, cycle])
    return {k: torch.from_numpy(rng.normal(0, 1e-2, s).astype(
        np.float32)).to(cuda) for k, s in SHAPES}


def test_concurrent_pulls_equal_the_replay_bitwise(cuda):
    rng = np.random.default_rng(1)
    params = {k: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
              for k, s in SHAPES}

    def store_on_card():
        ps.init(backend="cuda", mode="async", num_workers=WORKERS,
                dc_lambda=0.04)
        store = ps.KVStore(optimizer="sgd", learning_rate=0.05,
                           mode="async")
        store.init({k: v.to(cuda) for k, v in params.items()})
        return store

    svc = AsyncPSService(store_on_card(), record_full_history=True)
    pulled = {w: [] for w in range(WORKERS)}
    errors = []

    def worker(w):
        try:
            c = ps.connect_async(f"127.0.0.1:{svc.port}", w,
                                 {k: v.to(cuda) for k, v in params.items()},
                                 bucket_bytes=None if w == 0 else 1 << 19)
            pulled[w].append(c.pull_all())
            for i in range(ROUNDS):
                pulled[w].append(c.pull_all() if i % 2 else
                                 c.push_pull(_grads(w, i // 2, cuda)))
            c.close()
        except Exception as e:  # reported below
            errors.append((w, repr(e)))

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(WORKERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and not any(t.is_alive() for t in threads), errors
    events = list(svc.event_log)
    assert svc.transport.staging_bytes > 0
    svc.stop()
    ps.shutdown()
    eng = store_on_card()._engine
    seen = {w: 0 for w in range(WORKERS)}
    pushes = {w: 0 for w in range(WORKERS)}
    for op, w in events:
        if op == "pull":
            want = eng.pull_tree(worker=w)
            got = pulled[w][seen[w]]
            for k in want:
                assert torch.equal(got[k], want[k]), (w, seen[w], k)
            seen[w] += 1
        else:
            eng.push_tree(_grads(w, pushes[w], cuda), worker=w)
            pushes[w] += 1
    assert seen == {w: ROUNDS + 1 for w in range(WORKERS)}


def _sparse_services(cuda):
    from ps_tpu_torch.backends.remote_sparse import SparsePSService

    ps.init(backend="cuda")
    svcs = [SparsePSService(
        harness.sparse_tables("small", s, 2), shard=s, num_shards=2,
        total_rows={n: v for n, (v, _) in harness.sparse_spec(
            "small").items()},
        record_full_history=True) for s in range(2)]
    for svc in svcs:
        assert all(t.device == cuda for t in svc._tables.values())
        assert svc.fused_tiers == {"deep": "cuda", "wide": "cuda"}
    return svcs


def test_sparse_service_on_the_card_replays_bitwise(cuda, tmp_path):
    from ps_tpu_torch.ops import sparse_apply as ops

    cycles = 12
    svcs = _sparse_services(cuda)
    ports = ",".join(str(s.port) for s in svcs)
    ops.LAUNCHES = ops.GROUP_LAUNCHES = 0
    errors = []

    def worker(w):
        try:
            harness.run_sparse_worker(ports, str(tmp_path), w, cycles,
                                      "cuda", "small", WORKERS, True)
        except Exception as e:  # reported below
            errors.append((w, repr(e)))

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(WORKERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and not any(t.is_alive() for t in threads), errors
    infos = [{"apply_log": list(s.apply_log), "versions": dict(s.versions)}
             for s in svcs]
    applied = sum(len(i["apply_log"]) for i in infos)
    assert applied == sum(harness.expected_pushes("small", s, 2, WORKERS,
                                                  cycles) for s in range(2))
    # every applied push carries both tables: 2 grouping + 2 apply launches
    assert (ops.LAUNCHES, ops.GROUP_LAUNCHES) == (2 * applied, 2 * applied)
    served = [{n: t.table.clone() for n, t in s._tables.items()}
              for s in svcs]
    for s in svcs:
        assert s.transport.staging_bytes > 0
        s.stop()
    pulls = {w: (dict(np.load(tmp_path / f"sparse_pulls{w}.npz")),
                 json.loads((tmp_path / f"sparse_worker{w}.json").read_text()))
             for w in range(WORKERS)}
    tables, checked = harness.sparse_replay(infos, "small", WORKERS, cycles,
                                            pulls=pulls)
    assert checked >= WORKERS * cycles * 2
    for s in range(2):
        for n, emb in tables[s].items():
            assert torch.equal(emb.table, served[s][n]), (s, n)


def test_sparse_rows_come_back_on_the_ids_device(cuda):
    from ps_tpu_torch.backends.remote_sparse import connect_sparse

    svcs = _sparse_services(cuda)
    try:
        w = connect_sparse(",".join(f"127.0.0.1:{s.port}" for s in svcs), 0,
                           harness.sparse_spec("small"))
        ids = np.arange(0, 96, 5, dtype=np.int32)
        on_card = w.pull({"deep": torch.from_numpy(ids).to(cuda),
                          "wide": ids})
        assert on_card["deep"].device == cuda
        assert on_card["wide"].device == torch.device("cpu")
        want = torch.from_numpy(harness.sparse_table("small", "deep")[ids])
        assert torch.equal(on_card["deep"].cpu(), want)
        with pytest.raises(TypeError, match="bfloat16"):
            w.push({"deep": (ids, torch.ones(ids.size, 8, device=cuda,
                                              dtype=torch.bfloat16))})
        w.close()
    finally:
        for s in svcs:
            s.stop()
