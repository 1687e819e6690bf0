"""The readings that a cell's correctness limits are set from, on the card at
the cell's own size (not part of a benchmark run).

For each seed: the program's first steps through the window's own call,
against the float32 reference (the lower reading); on the control seeds,
the reference itself computed in float8 against the float32 reference
(the control); on the fault seeds, the program with half of each batch
left out and, apart, the program whose apply leaves its state unchanged
(the faults a one-card training cell can have). A state left unchanged
reads 1 on the gradient and change numbers by their definition; its run
reads the loss and the state it threads.

    python3 portbench/calibrate.py --workload bert_base.seq512 \\
        --seeds 1 2 3 --control-seeds 1 2 3 --fault-seeds 1 2 3 \\
        [--out calibrate.jsonl]

One JSON line a reading: ``{"cell", "seed", "kind", "gaps": {name:
[value, where]}}``.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    sys.path[:0] = [ROOT]
    import torch

    from portbench.harness import check, inputs, measure, spec

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=os.devnull)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    ref_mod, cfg = cell.reference, cell.config

    def reference(seed, precision="float32"):
        gw = torch.Generator(device).manual_seed(seed)
        params, state = ref_mod.init_params(cfg, gw, device)
        gd = torch.Generator(device).manual_seed(measure.data_seed(seed))
        pool = inputs.make_pool(cfg, cell.traffic, gd, device)
        return ref_mod.readings(cfg, params, state,
                                pool[:measure.CHECKED_STEPS], precision)

    def program(seed, fault=None):
        clock = measure.SetupClock()
        prog, pool, _, readings = measure.program_readings(
            cell, device, seed, fault, clock)
        prog.close()
        del prog, pool
        return readings

    refs = {}
    with open(args.out, "a") as sink:
        for kind, seeds in (("program", args.seeds),
                            ("half_batch", args.fault_seeds),
                            ("state_unchanged", args.fault_seeds),
                            ("control", args.control_seeds)):
            for seed in seeds:
                t = time.perf_counter()
                if seed not in refs:
                    refs[seed] = reference(seed)
                if kind == "control":
                    got = reference(seed, "fp8")
                else:
                    got = program(seed, None if kind == "program" else kind)
                torch.cuda.empty_cache()
                found = check.gaps(got, refs[seed])
                line = json.dumps({
                    "cell": cell.name, "seed": seed, "kind": kind,
                    "gaps": {k: [v, at] for k, (v, at) in found.items()},
                    "seconds": time.perf_counter() - t})
                print(line, flush=True)
                sink.write(line + "\n")
                sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
