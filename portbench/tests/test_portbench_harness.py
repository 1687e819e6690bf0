"""CPU tests of the benchmark's harness: the cells resolve, the names and
units keep to the format BENCHMARK.json is held to, the yardstick's
counts equal hand-worked values, nothing imports JAX, and the result
line has only its keys.

    python -m pytest portbench/tests -q
"""

import ast
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness import check, main, spec, trace, yardstick  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ps_tpu"}
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = spec.load_cell(cell)
    assert c.config["name"] == c.name.split(".")[0]
    assert c.system.build and c.system.step_flops
    assert c.reference.init_params and c.reference.readings
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert set(c.limits) >= {"loss_gap", "grad_gap", "change_gap"}


def test_names_units_and_keys_keep_to_the_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_flop_counts_equal_hand_worked_values():
    bert = spec.load_cell("bert_base.seq512").config
    # 12 x (4·768² + 2·768·3072 + 2·S·768) + 768² + 768·30522, x 6
    assert yardstick.bert_macs_per_token(bert, 512) * 6 == 710_415_360
    assert yardstick.bert_macs_per_token(bert, 128) * 6 == 667_948_032
    assert yardstick.bert_step_flops(bert, 32, 512) == 710_415_360 * 32 * 512
    from ps_tpu_torch.models.resnet import ResNet50

    rn = spec.load_cell("resnet50.b256").config
    assert yardstick.resnet_forward_macs(rn, 224) == \
        ResNet50().forward_macs(224) == 4_089_184_256
    assert yardstick.resnet_forward_macs(rn, 57) == \
        ResNet50().forward_macs(57)


def test_flash_roofline_bound_is_bytes_at_the_cells_shapes():
    card = "NVIDIA H100 80GB HBM3"
    flops, nbytes = yardstick.flash_fwd_cost(384, 512, 64, 2, 32)
    assert flops == 4 * 384 * 512 * 512 * 64
    assert nbytes == 4 * 384 * 512 * 64 * 2 + 4 * 384 * 512 + 4 * 32 * 512
    bound, by = yardstick.roofline_seconds(flops, nbytes, card)
    assert by == "bytes" and math.isclose(bound, nbytes / 3.35e12)
    assert math.isclose(bound * 1e3, 0.0303, rel_tol=0.01)
    bound, by = yardstick.roofline_seconds(
        *yardstick.flash_fwd_cost(768, 128, 64, 2, 64), card)
    assert by == "bytes" and math.isclose(bound * 1e3, 0.01514,
                                          rel_tol=0.01)
    assert yardstick.roofline_seconds(1, 1, "some other card") == (None,
                                                                    None)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "portbench").rglob("*.py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(ROOT / path)}
    assert not tops & FORBIDDEN
    if path.startswith("portbench/reference/"):
        assert "ps_tpu_torch" not in tops
        assert tops <= {"__future__", "contextlib", "math", "typing",
                        "torch", "portbench"}


def test_reference_imports_only_its_own_package():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        for name in _imports(path):
            if name.startswith("portbench"):
                assert name == "portbench.reference", (path, name)


def _timeline():
    ms = 1_000_000
    device = [(0, 2 * ms, "void flash_fwd_bf16_kernel<64>(CUtensorMap)"),
              (1 * ms, 3 * ms, "ampere_sgemm_128x64"),
              (5 * ms, 6 * ms, "Memcpy DtoD (Device -> Device)"),
              (8 * ms, 9 * ms, "flash_fwd_bf16_kernel<64>")]
    spans = {"window": [(0, 10 * ms)],
             "step": [(0, 4 * ms), (4 * ms, 9 * ms)],
             "server_apply": [(3 * ms, 4 * ms), (7 * ms, 8 * ms)]}
    return trace.Timeline((0, 10 * ms), device, spans)


def test_timeline_unions_intervals_and_labels_gaps():
    t = _timeline()
    assert t.busy_intervals == [(0, 3_000_000), (5_000_000, 6_000_000),
                                  (8_000_000, 9_000_000)]
    assert math.isclose(t.busy_s(), 0.005)
    assert len(t.kernels()) == 3
    assert t.idle_gaps() == [(3_000_000, 5_000_000), (6_000_000, 8_000_000),
                             (9_000_000, 10_000_000)]
    assert t.label(3_500_000) == "server_apply"
    assert t.label(6_000_000) == "fwd_bwd"
    assert t.label(8_500_000) == "step_tail"
    assert t.label(9_500_000) == "between_steps"
    b = t.breakdown()
    assert b["device_ops"][0] == ["flash_fwd_bf16_kernel<64>", 0.003]
    assert dict(b["idle_gaps"]) == {"server_apply": 0.002, "fwd_bwd": 0.002,
                                    "between_steps": 0.001}


class _Run:
    def __init__(self, cell, timeline):
        self.cell, self.timeline = cell, timeline
        self.card = "NVIDIA H100 80GB HBM3"
        self.steps, self.window_s = 2, 0.01
        self.step_ms = [4.0, 5.0]
        self.fwd_bwd_ms, self.apply_ms = [3.0, 4.0], [1.0, 1.0]
        self.memory_peak = 2**30
        self.nonfinite = 0

    @property
    def step_flops(self):
        return self.cell.system.step_flops(self.cell.config,
                                           self.cell.traffic)


def test_readers_and_result_line_keys():
    cell = spec.load_cell("bert_base.seq512")
    run = _Run(cell, _timeline())
    read = {m["name"]: spec.metric_reader(m["name"])(run)
            for m in cell.per_layer}
    assert read["kernels_per_step"] == 1.5
    assert read["fwd_bwd_ms"] == 3.5 and read["server_apply_ms"] == 1.0
    assert math.isclose(read["device_idle_pct"], 50.0)
    per_call = 0.0015
    assert math.isclose(read["flash_fwd_roofline_pct"],
                        100 * yardstick.roofline_seconds(
                            *yardstick.flash_fwd_cost(384, 512, 64, 2, 32),
                            run.card)[0] / per_call)
    assert math.isclose(read["mfu_pct"], 100 * 710_415_360 * 32 * 512 * 2
                        / 0.01 / 989e12)
    gaps = {"loss_gap": (1e-5, "step 1"), "grad_gap": (1e-3, "a"),
            "change_gap": (2e-3, "b")}
    ok, checks = check.judge(gaps, {"loss_gap": 1e-4, "grad_gap": 1e-2,
                                    "change_gap": 1e-3})
    assert not ok and checks["change_gap"]["limit"] == 1e-3
    out = {"run": run, "setup_s": 12.5}
    line = main.result(cell, out, False, ok, checks, run.card, 1)
    assert list(line) == RESULT_KEYS + ["checks"]
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert line["metrics"]["step_ms_p90"]["value"] == 4.9
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    traced = main.result(cell, out, True, ok, checks, run.card, 1)
    assert list(traced) == RESULT_KEYS + ["breakdown", "checks"]
    assert set(traced["metrics"]) == {m["name"] for m in cell.per_layer}
    assert set(traced["device"]) >= {"busy_s", "window_s"}
    assert len(traced["breakdown"]["device_ops"]) <= 10
    json.dumps(traced)


def test_a_reader_with_nothing_to_read_returns_none():
    cell = spec.load_cell("resnet50.b256")
    run = _Run(cell, None)
    run.fwd_bwd_ms = run.apply_ms = []
    for name in ("kernels_per_step", "fwd_bwd_ms", "server_apply_ms",
                 "flash_fwd_roofline_pct", "device_idle_pct"):
        assert spec.metric_reader(name)(run) is None


def test_quantile_is_numpys_linear():
    assert main.quantile([1.0, 2.0, 3.0, 4.0, 5.0], 0.9) == 4.6
    assert main.quantile([7.0], 0.9) == 7.0


def _run_bench(cwd: Path):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "bert_base.seq512", "--seed", str(2**31 + 12345), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_no_card_exits_nonzero_with_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    out = _run_bench(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "needs 1 card" in out.stderr


def test_benchmark_files_alone_exit_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_bench(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_loaded_forbidden_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ps_tpu_torch_like", object())
    assert main.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert main.loaded_forbidden() == ["jax"]
