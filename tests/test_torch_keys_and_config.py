"""The port's scaffold against the reference: parameter keys, the config
and its environment spellings, the synthetic data, ``init`` and the
trainer."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ps_tpu_torch
from ps_tpu.config import Config as RefConfig
from ps_tpu.data.synthetic import criteo_batches as ref_criteo_batches
from ps_tpu.kv import keys as ref_keys
from ps_tpu.models import wide_deep as ref_wd
from ps_tpu_torch.config import Config
from ps_tpu_torch.data.synthetic import criteo_batches
from ps_tpu_torch.examples import train_widedeep
from ps_tpu_torch.kv import keys
from ps_tpu_torch.models import wide_deep as wd


@pytest.fixture(autouse=True)
def _fresh_port():
    ps_tpu_torch.shutdown()
    yield
    ps_tpu_torch.shutdown()


def _flax_widedeep_params():
    cfg = ref_wd.WideDeepConfig(per_feature_vocab=50, embed_dim=8, mlp=(32, 16))
    rows = jnp.zeros((2, cfg.num_sparse, cfg.embed_dim))
    params = ref_wd.WideDeep(cfg).init(
        jax.random.key(0), jnp.zeros((2, cfg.num_dense)), rows,
        rows[..., :1])["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def test_keys_match_reference_on_widedeep_params():
    params = _flax_widedeep_params()
    want, _ = ref_keys.flatten_with_keys(params)
    got, treedef = keys.flatten_with_keys(params)
    assert list(got) == list(want)
    for k in want:
        assert got[k] is want[k]
    back = keys.unflatten(treedef, got, list(got))
    assert ref_keys.flatten_with_keys(back)[0].keys() == want.keys()


def test_keys_match_reference_on_nested_structures():
    tree = {"z": [1.0, {"b": 2.0, "a": (3.0, None, 4.0)}], "a": {"y": 5.0},
            "m": ()}
    want, _ = ref_keys.flatten_with_keys(tree)
    got, treedef = keys.flatten_with_keys(tree)
    assert list(got.items()) == list(want.items())
    assert keys.unflatten(treedef, got, list(got)) == tree


def test_port_model_registers_the_reference_layers_in_order():
    want, _ = ref_keys.flatten_with_keys(_flax_widedeep_params())
    model = wd.WideDeep(wd.WideDeepConfig(per_feature_vocab=50, embed_dim=8,
                                          mlp=(32, 16)))
    got, _ = keys.flatten_with_keys(model.param_tree())
    assert [k.replace("weight", "kernel") for k in got] == list(want)
    for k, v in got.items():
        w = want[k.replace("weight", "kernel")]
        assert tuple(v.shape) == (w.T.shape if k.endswith("weight") else w.shape)
    with pytest.raises(ValueError, match="do not match"):
        model.params_from_jax({"mlp_0/kernel": np.zeros((1, 1))})


def test_criteo_batches_are_byte_identical():
    kw = dict(num_dense=5, num_sparse=7, vocab_size=333, seed=5, steps=3)
    for got, want in zip(criteo_batches(9, **kw), ref_criteo_batches(9, **kw)):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes()


_ENV_PS = {
    "PS_BACKEND": "local", "PS_NUM_WORKERS": "4", "PS_COORDINATOR_URI": "h:1",
    "PS_NUM_PROCESSES": "2", "PS_PROCESS_ID": "1", "PS_MODE": "async",
    "PS_DC_LAMBDA": "0.1", "PS_SEED": "7", "PS_ROLE": "server",
    "PS_SERVER_URIS": "a:1,b:2", "PS_WORKER_ID": "3", "PS_SHARD": "1",
    "PS_NUM_SHARDS": "2", "PS_BUCKET_BYTES": "4096", "PS_TRANSPORT_POOL": "3",
    "PS_BUCKET_PRIORITY": "0", "PS_AGG_GROUP_SIZE": "2",
    "PS_AGG_FLUSH_TIMEOUT_MS": "150.5", "PS_COMPRESS": "int8",
    "PS_COMPRESS_TOPK": "0.05", "PS_COMPRESS_MIN_BYTES": "100",
    "PS_COMPRESS_PULL": "1", "PS_WRITEV": "0", "PS_SHM": "1",
    "PS_SHM_BYTES": "131072", "PS_VAN_NATIVE_LOOP": "1",
    "PS_VAN_LOOP_THREADS": "2", "PS_NATIVE_READ_CACHE_BYTES": "0",
    "PS_READ_STALENESS": "2", "PS_NL_STATS": "0", "PS_NL_SLOW_FRAME_MS": "10",
    "PS_PULL_CACHE": "1", "PS_READ_CONDITIONAL": "0",
    "PS_PUSH_NATIVE_ADMIT": "ON", "PS_FUSED_APPLY": "off",
    "PS_EMBED_DEVICE_ROWS": "1000", "PS_EMBED_ADMIT_FREQ": "3",
    "PS_EMBED_EVICT_TTL_MS": "50", "PS_EMBED_PREFETCH": "1",
    "PS_CONNECT_MAX_WAIT_MS": "500", "PS_AGG_PROBE_MAX_WAIT_MS": "20",
    "PS_CKPT_ROOT": "ckpts", "PS_REPLICAS": "2", "PS_REPLICA_ACK": "async",
    "PS_REPLICA_WINDOW": "16", "PS_FAILOVER_TIMEOUT_MS": "300",
    "PS_COORD_URI": "c:9", "PS_REBALANCE_AUTO": "1",
    "PS_REBALANCE_MAX_SKEW": "3.5", "PS_REBALANCE_REPORT_MS": "250",
    "PS_TELEMETRY": "0", "PS_TELEMETRY_WINDOW_S": "12",
    "PS_TELEMETRY_RING": "64", "PS_TELEMETRY_STRAGGLER_Z": "2.5",
    "PS_SLO_RULES": "push p99 < 10ms over 30s", "PS_FRESHNESS_SLO": "0.25",
    "PS_POLICY": "DRY", "PS_POLICY_COOLDOWN_S": "5",
    "PS_POLICY_BURN_WINDOWS": "2", "PS_CHAOS_SEED": "9",
    "PS_TRACE_SAMPLE": "0.5", "PS_TRACE_DIR": "traces", "PS_METRICS_PORT": "0",
    "PS_FLIGHT_EVENTS": "128", "PS_HEARTBEAT_BASE_PORT": "7000",
    "PS_PEER_HOSTS": "10.0.0.1:7777,10.0.0.2:7778",
    "PS_HEARTBEAT_BIND": "127.0.0.1", "PS_HEARTBEAT_INTERVAL_MS": "50",
    "PS_HEARTBEAT_TIMEOUT_MS": "500",
}
_ENV_ALIASES = {
    "DMLC_NUM_WORKER": "8", "DMLC_PS_ROOT_URI": "10.1.2.3",
    "DMLC_PS_ROOT_PORT": "9091", "DMLC_ROLE": "worker",
    "DMLC_NUM_SERVER": "4", "PS_ASYNC_SERVER_URI": "h0:1,h1:2,h2:3,h3:4",
}


@pytest.mark.parametrize("env", [_ENV_PS, _ENV_ALIASES, {}],
                         ids=["ps_vars", "dmlc_aliases", "defaults"])
def test_config_reads_every_reference_spelling(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ref, port = RefConfig.from_env(), Config.from_env()
    ref_fields = {f.name for f in dataclasses.fields(RefConfig)}
    # the port's own: the device, and the process group's backend (the
    # reference's jax.distributed has no such knob)
    assert {f.name for f in dataclasses.fields(Config)} == ref_fields | {
        "device", "dist_backend"}
    # the default backend differs: 'local' there, 'cuda' here
    differ = set() if "PS_BACKEND" in env else {"backend"}
    for name in sorted(ref_fields - differ):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.compress_spec() == ref.compress_spec()
    assert port.resolved_heartbeat_bind() == ref.resolved_heartbeat_bind()
    if env is _ENV_PS:
        assert port.heartbeat_peers() == ref.heartbeat_peers()


def test_config_validates_backend_device_and_tier():
    assert Config().backend == "cuda" and Config().device == "cuda"
    with pytest.raises(ValueError, match="unknown backend"):
        Config(backend="tpu")
    with pytest.raises(ValueError, match="unknown device"):
        Config(device="tpu")
    with pytest.raises(ValueError, match="unknown fused_apply"):
        Config(fused_apply="jax")
    with pytest.raises(ValueError, match="shm_bytes"):
        Config(shm_bytes=1)


def test_init_without_a_gpu_raises_and_does_not_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        ps_tpu_torch.init(backend="cuda")
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        ps_tpu_torch.init()
    assert not ps_tpu_torch.is_initialized()
    with pytest.raises(RuntimeError, match="not initialized"):
        ps_tpu_torch.current_context()


def test_init_on_the_cpu_only_on_request(monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
            ps_tpu_torch.init(backend="local")
    assert not ps_tpu_torch.is_initialized()
    ctx = ps_tpu_torch.init(backend="local", device="cpu", num_workers=3)
    assert ctx.device == torch.device("cpu") and ctx.num_workers == 3
    ps_tpu_torch.shutdown(abort=True)
    ctx = ps_tpu_torch.init(backend="cuda", device="cpu")
    assert ctx.device == torch.device("cpu") and ctx.num_workers == 1
    assert ctx.backend.fused_apply_tier() == "torch"
    with pytest.raises(RuntimeError, match="already initialized"):
        ps_tpu_torch.init(backend="cuda", device="cpu")
    ps_tpu_torch.shutdown()
    # one process is one rank: a mesh of 8 has no devices to run on
    with pytest.raises(ValueError, match="devices"):
        ps_tpu_torch.init(device="cpu", mesh_shape={"data": 8})


def test_example_trainer_runs_on_the_cpu(tmp_path, capsys):
    log = tmp_path / "log.jsonl"
    ex_s = train_widedeep.main(["--device", "cpu", "--steps", "3",
                                "--vocab", "20", "--batch-size", "8",
                                "--jsonl", str(log)])
    out = capsys.readouterr().out
    assert ex_s > 0 and "step    0  loss" in out and "done:" in out
    assert "sparse apply tier torch" in out
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert [x["step"] for x in lines] == [0, 2]
    assert all(np.isfinite(x["loss"]) for x in lines)
    assert not ps_tpu_torch.is_initialized()
