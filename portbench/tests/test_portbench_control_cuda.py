"""The control, on the card at each cell's own size: the plain reference
computed in float8 (the step below the configurations' bfloat16) put in
the program's place must come out not correct under the cell's limits,
on three seeds. Skips without a card.

    python -m pytest portbench/tests/test_portbench_control_cuda.py -q
"""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness import check, inputs, measure, spec  # noqa: E402

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's "
                    "own size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_the_float8_control_is_not_correct(card, cell_name):
    cell = spec.load_cell(cell_name)
    cfg = cell.config
    for seed in SEEDS:
        readings = {}
        for precision in ("float32", "fp8"):
            params, state = cell.reference.init_params(
                cfg, torch.Generator(card).manual_seed(seed), card)
            pool = inputs.make_pool(
                cfg, cell.traffic,
                torch.Generator(card).manual_seed(measure.data_seed(seed)),
                card)
            readings[precision] = cell.reference.readings(
                cfg, params, state, pool[:measure.CHECKED_STEPS], precision)
            del params, state, pool
            torch.cuda.empty_cache()
        correct, checks = check.judge(
            check.gaps(readings["fp8"], readings["float32"]), cell.limits)
        assert not correct, (seed, checks)
