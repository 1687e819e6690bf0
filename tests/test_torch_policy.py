"""The port's policy engine (``ps_tpu_torch/elastic/policy.py``) and the
coordinator's policy plumbing, against the reference's.

Every case of the reference's ``tests/test_policy.py`` runs through both
packages on the same inputs: the rules' signals and plans over plain-data
views (the ``_policy_view`` shape) with injected clocks, the brakes (burn
windows, hysteresis, the cooldown of an action class, one action at a
time), dry runs, an acting engine's audit, the coordinator's knobs and
its COORD_POLICY reply, the stamped hints and their expiry. Each case
returns what it saw (signals, plans, audit entries without their wall
time, state, counters) and the two records must be equal; the
reference's own assertions hold on both.

``test_policy_off_is_byte_identical`` boots port fleets: the same seeded
pushes land bitwise-equal parameters with no engine and with an armed,
quiet one, and bitwise the reference's fleet's (sgd at a power-of-two
rate).
"""

import time

import numpy as np
import pytest
import torch

import ps_tpu_torch


@pytest.fixture(autouse=True)
def _fresh_port():
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()
    yield
    if ps_tpu_torch.is_initialized():
        ps_tpu_torch.shutdown()


def _pkg(name):
    """The policy, coordinator and member modules of one package."""
    if name == "reference":
        from ps_tpu.elastic import coordinator, member, policy
    else:
        from ps_tpu_torch.elastic import coordinator, member, policy
    return policy, coordinator, member


def member(shard, uri=None, kind="dense", keys=3, nbytes=3000,
           hb="alive", report=None, handled=False):
    return {"shard": shard, "uri": uri or f"127.0.0.1:{9000 + shard}",
            "kind": kind, "node": shard, "hb_state": hb, "hb_age_ms": 10,
            "keys": keys, "nbytes": nbytes, "report": report or {},
            "handled": handled}


def view(members, **kw):
    v = {"now": 0.0, "members": members, "spares": [],
         "rebalancing": False, "hints": [], "slo": [], "skew": None,
         "max_skew": 2.0}
    v.update(kw)
    return v


def straggler_hint(shard):
    return {"kind": "straggler", "shard": shard, "t": 0.0, "window_s": 2.0}


def slo_state(breached=True, value_ms=500.0, threshold_ms=400.0):
    return {"rule": "push_pull p99 < 400ms over 2s",
            "metric": "ps_push_pull_seconds", "q": 0.99, "window_s": 2.0,
            "threshold_ms": threshold_ms, "value_ms": value_ms,
            "breached": breached}


def _clean(entries):
    """Audit entries without their wall-clock stamp."""
    return [{k: v for k, v in e.items() if k != "t"} for e in entries]


def _both(case):
    """Run ``case(policy, coordinator, member)`` for each package; the two
    records must be equal. Returns the port's."""
    ref = case(*_pkg("reference"))
    port = case(*_pkg("port"))
    assert port == ref
    return port


# -- the rules' signals and plans -------------------------------------------------


def test_hotspot_signal_levels_and_plans():
    def case(P, _c, _m):
        r = P.HotspotRebalance()
        fleet = [member(i) for i in range(4)]
        v = view(fleet, hints=[straggler_hint(1)])
        out = [r.signal(v), r.plan(v)]
        out += [r.signal(view(fleet, slo=[slo_state()])),
                r.signal(view(fleet, slo=[slo_state(breached=False,
                                                    value_ms=350.0)])),
                r.signal(view(fleet, slo=[slo_state(breached=False,
                                                    value_ms=100.0)]))]
        v = view(fleet, skew=3.0, max_skew=2.0)
        out += [r.signal(v), r.plan(v),
                r.signal(view(fleet, skew=1.9, max_skew=2.0)),
                r.signal(view(fleet, skew=float("inf"), max_skew=2.0))]
        dead = [member(0), member(1), member(2, hb="dead")]
        out.append(r.plan(view(dead, hints=[straggler_hint(1)])))
        assert out == [P.FIRING, {"targets": [0, 2, 3], "suspects": [1]},
                       P.FIRING, P.ELEVATED, P.QUIET, P.FIRING,
                       {"targets": [0, 1, 2, 3]}, P.ELEVATED, P.QUIET,
                       {"targets": [0], "suspects": [1]}]
        return out

    _both(case)


def test_replica_reseed_candidates_and_plan():
    def case(P, _c, _m):
        r = P.ReplicaReseed()
        pair = "127.0.0.1:9000|127.0.0.1:9001"
        consumed = member(0, uri=pair, report={
            "repl": {"attached": False, "degraded": False,
                     "promoted": True}})
        out = [r.signal(view([consumed])), r.plan(view([consumed])), r.why,
               r.plan(view([consumed], spares=["127.0.0.1:9002"]))]
        out += [r.signal(view([member(0, uri=pair, report={
                    "repl": {"attached": True, "degraded": True,
                             "promoted": False}})])),
                r.signal(view([member(0, uri=pair, hb="dead")])),
                r.signal(view([member(0, hb="dead")])),
                r.signal(view([member(0, uri=pair, hb="dead",
                                      handled=True)])),
                r.signal(view([member(0, uri=pair, report={
                    "repl": {"attached": True, "degraded": False,
                             "promoted": False}})]))]
        assert out == [P.FIRING, None, "no_spare",
                       {"shard": 0, "uri": pair, "spare": "127.0.0.1:9002"},
                       P.FIRING, P.FIRING, P.QUIET, P.QUIET, P.QUIET]
        return out

    _both(case)


def test_shard_add_needs_standby_and_breach():
    def case(P, _c, _m):
        r = P.ShardAdd()
        loaded = [member(0), member(1)]
        standby = loaded + [member(2, keys=0, nbytes=0)]
        out = [r.signal(view(loaded, slo=[slo_state()])),
               r.signal(view(standby)),
               r.signal(view(standby, slo=[slo_state()])),
               r.signal(view(standby, slo=[slo_state(breached=False,
                                                     value_ms=350.0)])),
               r.plan(view(standby, slo=[slo_state()]))]
        assert out == [P.QUIET, P.QUIET, P.FIRING, P.ELEVATED,
                       {"targets": [0, 1, 2]}]
        return out

    _both(case)


def test_shard_drain_underload_and_emptiest_leave_first():
    def case(P, _c, _m):
        r = P.ShardDrain(qps_floor=1.0, min_shards=2)
        fleet = [member(0, nbytes=9000, report={"push_qps": 0.1}),
                 member(1, nbytes=8000, report={"push_qps": 0.1}),
                 member(2, nbytes=100, report={"push_qps": 0.0}),
                 member(3, nbytes=100, report={"push_qps": 0.0})]
        out = [r.signal(view(fleet)), r.plan(view(fleet)),
               r.signal(view(fleet[:2])),
               r.signal(view([member(i) for i in range(4)])),
               r.signal(view([member(i, report={"push_qps": 5.0})
                              for i in range(4)])),
               r.signal(view([member(i, report={"push_qps": 0.4})
                              for i in range(4)]))]
        assert out == [P.FIRING, {"drain": [2, 3]}, P.QUIET, P.QUIET,
                       P.QUIET, P.ELEVATED]
        return out

    _both(case)


# -- the engine's brakes ------------------------------------------------------------


def _dry_engine(P, rules, burn=2, cooldown=100.0):
    return P.PolicyEngine(mode="dry", cooldown_s=cooldown,
                          burn_windows=burn, tick_s=0.0, rules=rules)


def test_fire_needs_full_burn_and_one_window_shorter_does_not():
    def case(P, _c, _m):
        fire_v = view([member(i) for i in range(4)],
                      hints=[straggler_hint(1)])
        eng = _dry_engine(P, [P.HotspotRebalance()], burn=3)
        out = [eng.tick(fire_v, now=1.0), eng.tick(fire_v, now=2.0),
               dict(eng.actions_total)]
        [entry] = eng.tick(fire_v, now=3.0)
        assert entry["outcome"] == "dry"
        assert entry["detail"] == {"targets": [0, 2, 3], "suspects": [1]}
        out += [_clean([entry]), dict(eng.actions_total)]
        eng2 = _dry_engine(P, [P.HotspotRebalance()], burn=3)
        quiet_v = view([member(i) for i in range(4)])
        out.append([eng2.tick(v, now=float(i)) for i, v in enumerate(
            [fire_v, fire_v, quiet_v, fire_v, fire_v])])
        assert out[0] == out[1] == [] and out[2] == {}
        assert out[5] == [[]] * 5
        return [str(x) for x in out]

    _both(case)


def test_flapping_fires_exactly_once_cooldown_and_hysteresis():
    def case(P, _c, _m):
        fire_v = view([member(i) for i in range(4)],
                      hints=[straggler_hint(1)])
        quiet_v = view([member(i) for i in range(4)])
        eng = _dry_engine(P, [P.HotspotRebalance()], burn=2,
                          cooldown=1000.0)
        now = [0.0]

        def tick(v):
            now[0] += 1.0
            return eng.tick(v, now=now[0])

        trail = [tick(fire_v), tick(fire_v)]
        for _ in range(5):
            trail += [tick(quiet_v), tick(quiet_v), tick(fire_v),
                      tick(fire_v)]
        assert eng.actions_total == {("rebalance", "dry"): 1}
        assert eng.suppressed_total.get("cooldown", 0) >= 5
        eng2 = _dry_engine(P, [P.HotspotRebalance()], burn=2, cooldown=1.0)
        elev_v = view([member(i) for i in range(4)],
                      slo=[slo_state(breached=False, value_ms=350.0)])
        eng2.tick(fire_v, now=1.0)
        eng2.tick(fire_v, now=2.0)
        later = [eng2.tick(elev_v if i % 2 else fire_v, now=10.0 + i)
                 for i in range(10)]
        assert later == [[]] * 10
        assert eng2.actions_total == {("rebalance", "dry"): 1}
        return ([_clean(t) for t in trail], dict(eng.suppressed_total),
                str(eng.actions_total), str(eng2.actions_total))

    _both(case)


class _Always:
    """A rule that always fires (built on either package's PolicyRule)."""

    @staticmethod
    def make(P, name, action):
        class Always(P.PolicyRule):
            def signal(self, view):
                return P.FIRING

            def plan(self, view):
                return {"from": self.name}

        r = Always()
        r.name, r.action = name, action
        return r


def test_one_action_per_tick_and_inflight_suppression():
    def case(P, _c, _m):
        eng = _dry_engine(P, [_Always.make(P, "a", "act_a"),
                              _Always.make(P, "b", "act_b")], burn=1)
        entries = eng.tick(view([member(0)]), now=1.0)
        assert [e["outcome"] for e in entries] == ["dry", "suppressed"]
        assert entries[1]["detail"]["reason"] == "inflight"
        eng2 = _dry_engine(P, [_Always.make(P, "a", "act_a")], burn=1)
        [e] = eng2.tick(view([member(0)], rebalancing=True), now=1.0)
        assert e["detail"]["reason"] == "inflight"
        return (_clean(entries), dict(eng.suppressed_total), _clean([e]))

    _both(case)


def test_dry_run_records_but_never_executes():
    # one clock reading for both packages: the entry records it as "mono"
    now = time.monotonic()

    def case(P, _c, _m):
        calls = []
        eng = P.PolicyEngine(
            mode="dry", actions={"rebalance": lambda d: calls.append(d)},
            cooldown_s=100.0, burn_windows=1, tick_s=0.0,
            rules=[P.HotspotRebalance()])
        v = view([member(i) for i in range(4)], hints=[straggler_hint(2)])
        [entry] = eng.tick(v, now=now)
        assert entry["outcome"] == "dry" and calls == []
        st = eng.state()
        assert st["actions_total"] == {"rebalance:dry": 1}
        assert not st["rules"]["hotspot_rebalance"]["armed"]
        assert "rebalance" in st["cooldown"]
        text = eng.render_prometheus()
        assert ('ps_policy_actions_total{action="rebalance",'
                'outcome="dry"} 1') in text
        st.pop("cooldown")  # seconds left, read off the live clock
        last = st.pop("last_action")
        return (_clean([entry]), st, _clean([last]), text,
                _clean([eng.last_action()]))

    _both(case)


def test_engine_executes_and_audit_mutates_in_place():
    def settle(entry):
        deadline = time.monotonic() + 5.0
        while entry["outcome"] == "started" and time.monotonic() < deadline:
            time.sleep(0.01)
        return entry

    def case(P, _c, _m):
        done = []
        eng = P.PolicyEngine(
            mode="on", actions={"rebalance": lambda d: done.append(d)
                                or {"moves": 1}},
            cooldown_s=100.0, burn_windows=1, tick_s=0.0,
            rules=[P.HotspotRebalance()])
        v = view([member(i) for i in range(4)], hints=[straggler_hint(1)])
        [entry] = eng.tick(v, now=1.0)
        assert entry["outcome"] in ("started", "ok")
        settle(entry)
        assert entry["outcome"] == "ok" and entry["result"] == {"moves": 1}
        assert done == [{"targets": [0, 2, 3], "suspects": [1]}]
        eng2 = P.PolicyEngine(
            mode="on", actions={"rebalance": lambda d: 1 / 0},
            cooldown_s=100.0, burn_windows=1, tick_s=0.0,
            rules=[P.HotspotRebalance()])
        [e2] = eng2.tick(v, now=1.0)
        settle(e2)
        assert e2["outcome"] == "failed"
        assert "ZeroDivisionError" in e2["result"]["error"]
        strip = [{k: v for k, v in e.items() if k not in ("t", "seconds")}
                 for e in (entry, e2)]
        return strip, str(eng.actions_total), str(eng2.actions_total)

    _both(case)


# -- the coordinator's plumbing ----------------------------------------------------


def test_coordinator_policy_knobs_and_wire_surface():
    def case(_p, C, M):
        coord = C.Coordinator(bind="127.0.0.1", policy="dry",
                              policy_cooldown_s=5.0, policy_burn_windows=2)
        try:
            eng = coord.policy
            assert (eng.mode, eng.cooldown_s, eng.burn_windows) == \
                ("dry", 5.0, 2)
            out = M.fetch_policy(f"127.0.0.1:{coord.port}")
            assert set(out["rules"]) == {"hotspot_rebalance",
                                         "replica_reseed", "shard_add",
                                         "shard_drain"}
        finally:
            coord.stop()
        coord2 = C.Coordinator(bind="127.0.0.1")
        try:
            assert coord2.policy is None
            off = M.fetch_policy(f"127.0.0.1:{coord2.port}")
        finally:
            coord2.stop()
        assert off == {"mode": "off"}
        return out, off

    _both(case)


def test_policy_bad_mode_is_loud():
    for name in ("reference", "port"):
        P = _pkg(name)[0]
        with pytest.raises(ValueError, match="dry/on"):
            P.PolicyEngine(mode="sometimes")


def _policy_run(policy, reference):
    """Ten seeded pushes through a coordinator-joined shard and worker of
    one package; the final params and the engine's audit."""
    rng = np.random.default_rng(11)
    tree = {f"k{i}": rng.standard_normal((256,)).astype(np.float32)
            for i in range(4)}
    grads = {k: np.full((256,), 1e-3, np.float32) for k in tree}
    if reference:
        import ps_tpu as ps
        from ps_tpu.backends.remote_async import AsyncPSService
        from ps_tpu.backends.remote_async import connect_async
        from ps_tpu.elastic import Coordinator

        init, shutdown = (lambda: ps.init(backend="tpu", mode="async",
                                          num_workers=1, dc_lambda=0.0),
                          ps.shutdown)
        store_cls, like = ps.KVStore, tree
    else:
        ps = ps_tpu_torch
        from ps_tpu_torch.backends.remote_async import AsyncPSService
        from ps_tpu_torch.backends.remote_async import connect_async
        from ps_tpu_torch.elastic import Coordinator

        init, shutdown = (lambda: ps.init(backend="cuda", device="cpu",
                                          mode="async", num_workers=1,
                                          dc_lambda=0.0), ps.shutdown)
        store_cls = ps.KVStore
        like = {k: torch.from_numpy(v) for k, v in tree.items()}
    init()
    try:
        st = store_cls(optimizer="sgd", learning_rate=0.5, mode="async")
        st.init({k: np.array(v) for k, v in tree.items()} if reference
                else {k: torch.from_numpy(np.array(v))
                      for k, v in tree.items()})
        coord = Coordinator(bind="127.0.0.1", policy=policy,
                            telemetry_window_s=2.0)
        ca = f"127.0.0.1:{coord.port}"
        svc = AsyncPSService(st, bind="127.0.0.1", coordinator=ca)
        w = connect_async(None, 0, like, coordinator=ca)
        try:
            w.pull_all()
            for _ in range(10):
                w.push_pull(grads if reference else
                            {k: torch.from_numpy(g)
                             for k, g in grads.items()})
            params = {k: np.array(st._engine._params[k]) for k in tree}
            audit = list(coord.policy.audit()) if coord.policy else []
            return params, audit
        finally:
            w.close()
            svc.stop()
            coord.stop()
    finally:
        shutdown()


def test_policy_off_is_byte_identical():
    """Policy off changes nothing: the same seeded pushes land the same
    params bitwise with no engine and with an armed, quiet one, and
    bitwise the reference fleet's."""
    p_off, audit_off = _policy_run("off", reference=False)
    p_on, audit_on = _policy_run("on", reference=False)
    ref, ref_audit = _policy_run("on", reference=True)
    assert audit_off == [] and audit_on == [] and ref_audit == []
    for k in p_off:
        np.testing.assert_array_equal(p_off[k], p_on[k], err_msg=k)
        np.testing.assert_array_equal(p_on[k], ref[k], err_msg=k)


def test_hints_stamping_and_expiry():
    def case(_p, C, M):
        coord = C.Coordinator(bind="127.0.0.1", max_skew=2.0)
        members = []
        try:
            members.append(M.CoordinatorMember(
                f"127.0.0.1:{coord.port}", "127.0.0.1:9100",
                {"a": 100_000}))
            members.append(M.CoordinatorMember(
                f"127.0.0.1:{coord.port}", "127.0.0.1:9101", {"b": 100}))
            # a stamp is rounded to the millisecond: read the clock a
            # millisecond after the last registration stamped it
            time.sleep(0.001)
            now = time.monotonic()
            hints = coord.hints(now=now)
            assert len(hints) == 1 and hints[0]["kind"] == "byte_skew"
            assert hints[0]["t"] <= now and hints[0]["window_s"] > 0
            w = hints[0]["window_s"]
            assert coord.hints(now=now + 2.0 * w)
            assert coord.hints(now=now + 3.0 * w + 1.0) == []
            return [{k: v for k, v in h.items() if k != "t"}
                    for h in hints]
        finally:
            for m in members:
                m.close()
            coord.stop()

    _both(case)
