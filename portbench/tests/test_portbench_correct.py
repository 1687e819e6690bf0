"""CPU tests of what decides ``correct``: the plain references agree with
``ps_tpu_torch`` at tiny sizes (loss, gradients, one optimizer step),
and a run whose timed path is broken underneath comes out not correct
under the cell's own limits, while the same run unbroken comes out
correct.

    python -m pytest portbench/tests -q
"""

import dataclasses
import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness import check, inputs, measure, spec  # noqa: E402
from portbench.reference import common  # noqa: E402

CPU = torch.device("cpu")


def _tiny(cell_name):
    """The cell with the configuration and traffic cut to test size, in
    float32, and the cell's own limits."""
    cell = spec.load_cell(cell_name)
    if cell.config["system"] == "bert_mlm":
        cfg = dict(cell.config, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=128,
                   vocab_size=1500, max_position_embeddings=128,
                   compute_dtype="float32")
        traffic = dict(cell.traffic, batch=4, seq_len=128, pool=4)
    else:
        cfg = dict(cell.config, stage_sizes=[1, 1, 1, 1], num_filters=8,
                   num_classes=10, compute_dtype="float32")
        traffic = dict(cell.traffic, batch=8, image_size=32, pool=4)
    return dataclasses.replace(cell, config=cfg, traffic=traffic)


@pytest.mark.parametrize("cell_name", ["bert_base.seq512", "resnet50.b256"])
def test_reference_matches_the_port_at_tiny_size(cell_name):
    cell = _tiny(cell_name)
    cfg = cell.config
    params, state = cell.reference.init_params(
        cfg, torch.Generator().manual_seed(3), CPU)
    pool = inputs.make_pool(cfg, cell.traffic,
                            torch.Generator().manual_seed(4), CPU)
    prog = cell.system.build(cfg, params, state, CPU)
    try:
        loss = prog.step(pool[0])
        name = cfg["optimizer"]["name"]
        got_g = {k: (prog.store.optimizer_state(k)["mu"] / 0.1
                     if name == "lamb" else prog.store.optimizer_state(k))
                 for k in prog.store.keys()}
        got_p = {k: v.clone() for k, v in prog.params().items()}
        got_s = {k: v.clone() for k, v in prog.state().items()}
    finally:
        prog.close()
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    with common.full_float32():
        ref_loss, ref_s = cell.reference.loss_fn(cfg)(
            p, dict(state), pool[0], common.Precision())
        grads = dict(zip(p, torch.autograd.grad(ref_loss, list(p.values()))))
    new = {k: v.detach().clone() for k, v in p.items()}
    common.make_optimizer(cfg["optimizer"], new).step(new, grads)
    torch.testing.assert_close(loss, ref_loss.detach(), rtol=1e-5, atol=1e-6)
    scale = max(float(g.abs().max()) for g in grads.values())
    for k in grads:
        torch.testing.assert_close(got_g[k], grads[k], rtol=1e-3,
                                   atol=1e-5 * scale, msg=k)
        torch.testing.assert_close(got_p[k], new[k], rtol=1e-5, atol=1e-6,
                                   msg=k)
    for k in ref_s:
        torch.testing.assert_close(got_s[k], ref_s[k], rtol=1e-5, atol=1e-6,
                                   msg=k)


@pytest.mark.parametrize("cell_name", ["bert_base.seq512", "resnet50.b256"])
@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch"])
def test_a_broken_timed_path_is_not_correct(cell_name, fault):
    cell = _tiny(cell_name)
    out = measure.measure(cell, 2**31 + 77, 0.3, False, CPU,
                          time.perf_counter(), "cpu", fault=fault)
    correct, checks = check.judge(out["gaps"], cell.limits)
    assert out["run"].steps > 0
    assert correct == (fault is None), checks
    assert list(checks) == list(cell.limits)


def test_every_cell_has_a_limit_for_each_number_it_reads():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        state = cell.config["system"] == "resnet"
        assert set(cell.limits) == ({"loss_gap", "grad_gap", "change_gap"}
                                    | ({"state_gap"} if state else set()))
        assert all(v > 0 for v in cell.limits.values())


def test_gaps_take_the_worst_leaf_against_the_larger_norm():
    ref = {"losses": [2.0], "grad_norms": {"a": 1.0, "b": 1e-9, "c": 3.0},
           "change_norms": {"a": 1.0, "b": 5.0, "c": 2.0},
           "state_change_norms": {}}
    prog = {"losses": [2.002], "grad_norms": {"a": 1.01, "b": 0.2,
                                              "c": 3.0},
            "change_norms": {"a": 1.0, "b": 0.0, "c": 2.2},
            "state_change_norms": {}}
    found = check.gaps(prog, ref)
    assert found["loss_gap"][0] == pytest.approx(1e-3)
    # b's gradient is nought: measured against the median leaf's norm
    assert found["grad_gap"] == (pytest.approx(0.2), "b")
    # b is left out of the change: its reference gradient is negligible
    assert found["change_gap"] == (pytest.approx(0.1), "c")
    assert "state_gap" not in found
