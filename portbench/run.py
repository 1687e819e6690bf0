"""Run one cell of the port's benchmark: see ``portbench/harness/main.py``.

    python3 portbench/run.py --workload bert_base.seq512 --seed 7 \\
        --seconds 30 --trace 0
"""

import os
import sys
import time


def _since_process_start() -> float:
    """Seconds since this process started (Linux: its start time in clock
    ticks after boot, against the uptime); 0 where that is not readable."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T0 = time.perf_counter() - _since_process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path[:0] = [ROOT]
    # every build and kernel cache of the program at a fixed path in the
    # checkout (the port's own kernels build into build/ps_tpu_torch/)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    import ps_tpu_torch

    here = os.path.dirname(os.path.abspath(ps_tpu_torch.__file__))
    if os.path.dirname(here) != ROOT:
        sys.exit(f"portbench: ps_tpu_torch was imported from {here}, not "
                 f"from this checkout ({ROOT})")
    from portbench.harness.main import main

    sys.exit(main(sys.argv[1:], T0))
