"""``fwd_bwd_ms``: the median step's forward and backward on the device,
from the CUDA event at the previous step's end to the one the benchmark
records at the entry of the store's ``CudaServer.step_``."""

import statistics


def read(run):
    return statistics.median(run.fwd_bwd_ms) if run.fwd_bwd_ms else None
