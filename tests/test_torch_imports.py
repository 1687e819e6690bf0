"""Import hygiene of the port: ``ps_tpu_torch/`` and ``chip_smoke.py``
import no jax, flax, optax, tensorflow or ps_tpu (the reference package;
the name ``ps_tpu_torch`` is the port's own), and no ``try`` falls back to a
kernel's plain version (the sparse apply's ``_apply_torch``, flash
attention's ``_flash_fwd_torch``) when something fails."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "tensorflow", "ps_tpu"}
PLAIN_VERSIONS = {"_apply_torch", "_flash_fwd_torch"}
FILES = sorted(str(p.relative_to(ROOT))
               for p in (ROOT / "ps_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]


def _called_names(node):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            f = sub.func
            if isinstance(f, ast.Name):
                yield f.id
            elif isinstance(f, ast.Attribute):
                yield f.attr


def violations(source: str) -> list:
    """What the hygiene rules forbid in one module's source."""
    out = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            names = []
        for name in names:
            if name.split(".")[0] in FORBIDDEN:
                out.append(f"line {node.lineno}: imports {name}")
        if isinstance(node, ast.Try):
            for handler in node.handlers:
                for name in sorted(PLAIN_VERSIONS
                                   & set(_called_names(handler))):
                    out.append(f"line {handler.lineno}: falls back to "
                               f"{name} in an except handler")
    return out


@pytest.mark.parametrize("path", FILES)
def test_port_file_is_clean(path):
    assert violations((ROOT / path).read_text()) == []


def test_every_slice_module_is_checked():
    for path in ("ps_tpu_torch/models/resnet.py", "ps_tpu_torch/data/files.py",
                 "ps_tpu_torch/data/prefetch.py",
                 "ps_tpu_torch/data/synthetic.py",
                 "ps_tpu_torch/utils/metrics.py",
                 "ps_tpu_torch/utils/step_log.py",
                 "ps_tpu_torch/utils/profiling.py",
                 "ps_tpu_torch/examples/train_resnet50.py",
                 "ps_tpu_torch/backends/common.py",
                 "ps_tpu_torch/backends/local.py",
                 "ps_tpu_torch/optim/dc.py", "ps_tpu_torch/models/mlp.py",
                 "ps_tpu_torch/models/draws.py",
                 "ps_tpu_torch/examples/train_mnist_mlp.py",
                 "ps_tpu_torch/examples/train_mnist_async.py",
                 "ps_tpu_torch/checkpoint.py", "chip_smoke.py",
                 "ps_tpu_torch/parallel/__init__.py",
                 "ps_tpu_torch/parallel/collectives.py",
                 "ps_tpu_torch/parallel/mesh.py",
                 "ps_tpu_torch/parallel/sharding.py",
                 "ps_tpu_torch/backends/cuda.py", "ps_tpu_torch/kv/store.py",
                 "ps_tpu_torch/kv/sparse.py", "ps_tpu_torch/train.py",
                 "ps_tpu_torch/models/bert.py", "ps_tpu_torch/config.py",
                 "ps_tpu_torch/api.py",
                 "ps_tpu_torch/examples/train_widedeep.py",
                 "ps_tpu_torch/native/__init__.py",
                 "ps_tpu_torch/control/__init__.py",
                 "ps_tpu_torch/control/tensor_van.py",
                 "ps_tpu_torch/control/heartbeat.py",
                 "ps_tpu_torch/backends/van_service.py",
                 "ps_tpu_torch/backends/remote_async.py",
                 "ps_tpu_torch/backends/remote_sparse.py",
                 "ps_tpu_torch/backends/aggregator.py",
                 "ps_tpu_torch/kv/tiered.py",
                 "ps_tpu_torch/kv/keys.py",
                 "ps_tpu_torch/control/shm_lane.py",
                 "ps_tpu_torch/control/native_loop.py",
                 "ps_tpu_torch/compress/__init__.py",
                 "ps_tpu_torch/compress/codecs.py",
                 "ps_tpu_torch/compress/policy.py",
                 "ps_tpu_torch/compress/wire.py",
                 "ps_tpu_torch/replica/__init__.py",
                 "ps_tpu_torch/replica/log.py",
                 "ps_tpu_torch/replica/session.py",
                 "ps_tpu_torch/replica/watch.py",
                 "ps_tpu_torch/obs/__init__.py",
                 "ps_tpu_torch/obs/freshness.py",
                 "ps_tpu_torch/obs/clock.py",
                 "ps_tpu_torch/obs/metrics.py",
                 "ps_tpu_torch/obs/trace.py",
                 "ps_tpu_torch/obs/flight.py",
                 "ps_tpu_torch/obs/http.py",
                 "ps_tpu_torch/obs/slo.py",
                 "ps_tpu_torch/obs/straggler.py",
                 "ps_tpu_torch/obs/breakdown.py",
                 "ps_tpu_torch/obs/collector.py",
                 "ps_tpu_torch/obs/tsdb.py",
                 "ps_tpu_torch/elastic/__init__.py",
                 "ps_tpu_torch/elastic/table.py",
                 "ps_tpu_torch/elastic/member.py",
                 "ps_tpu_torch/elastic/migrate.py",
                 "ps_tpu_torch/elastic/policy.py",
                 "ps_tpu_torch/elastic/coordinator.py",
                 "ps_tpu_torch/chaos/__init__.py",
                 "ps_tpu_torch/chaos/inject.py",
                 "ps_tpu_torch/chaos/member.py",
                 "ps_tpu_torch/utils/chips.py"):
        assert path in FILES


def test_van_plane_loads_neither_jax_nor_its_package():
    """The van plane (the native loader, control/ with the shm lane and
    the native loop, the codecs, the services and the remote workers,
    dense and sparse, the aggregator, replica/, obs/ with its metrics,
    traces, flight recorder, /metrics endpoint, SLOs, straggler
    detector, breakdown, collector and time series, elastic/ with the
    coordinator and the policy engine, chaos/ with its injector and
    subprocess members, and the chips table) runs without JAX and never
    reaches into
    ps_tpu/: its modules load no jax, jaxlib, flax, optax, tensorflow or
    ps_tpu, and the native loader builds the port's own copy of
    van.cpp."""
    code = ("import sys, ps_tpu_torch.native as n, "
            "ps_tpu_torch.control.tensor_van, ps_tpu_torch.control.heartbeat, "
            "ps_tpu_torch.control.shm_lane, ps_tpu_torch.control.native_loop, "
            "ps_tpu_torch.compress, "
            "ps_tpu_torch.backends.van_service, "
            "ps_tpu_torch.backends.remote_async, "
            "ps_tpu_torch.backends.remote_sparse, "
            "ps_tpu_torch.backends.aggregator, ps_tpu_torch.replica, "
            "ps_tpu_torch.obs, ps_tpu_torch.obs.clock, "
            "ps_tpu_torch.elastic, ps_tpu_torch.elastic.policy, "
            "ps_tpu_torch.chaos, ps_tpu_torch.chaos.inject, "
            "ps_tpu_torch.chaos.member, ps_tpu_torch.utils.chips, "
            "ps_tpu_torch.utils.step_log; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'optax', 'tensorflow', 'ps_tpu'}), "
            "n._DIR.name, n._DIR.parent.name)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.split() == ["[]", "native", "ps_tpu_torch"]


def test_parallel_modules_load_neither_jax_nor_its_package():
    """The multi-device layer runs on torch.distributed alone: importing
    ``ps_tpu_torch.parallel`` (mesh, collectives, sharding) loads no module
    of jax, jaxlib, flax, optax or ps_tpu."""
    code = ("import sys, ps_tpu_torch.parallel.mesh, "
            "ps_tpu_torch.parallel.collectives, "
            "ps_tpu_torch.parallel.sharding; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'optax', 'ps_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_checkpoint_module_loads_neither_jax_nor_orbax():
    """A port checkpoint is read and written without JAX: importing
    ``ps_tpu_torch.checkpoint`` (and through it the package) loads no
    module of jax, jaxlib, orbax, flax, optax or ps_tpu."""
    code = ("import sys, ps_tpu_torch.checkpoint; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'orbax', 'flax', 'optax', 'ps_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_checker_catches_what_it_forbids():
    bad = (
        "import jax.numpy as jnp\n"
        "from ps_tpu.kv import keys\n"
        "import flax, os\n"
        "from optax import adam\n"
        "try:\n"
        "    out = _apply_cuda(a)\n"
        "except RuntimeError:\n"
        "    out = ops._apply_torch(a)\n"
        "try:\n"
        "    out = _flash_fwd_cuda(q, k, v)\n"
        "except Exception:\n"
        "    out = _flash_fwd_torch(q, k, v)\n"
    )
    assert len(violations(bad)) == 6
    good = ("import ps_tpu_torch\nfrom ps_tpu_torch.ops import sparse_apply\n"
            "from . import jaxlike\ntry:\n    x = 1\nexcept ValueError:\n"
            "    raise\n")
    assert violations(good) == []
