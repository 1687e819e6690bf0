"""``server_apply_ms``: the median step's server apply on the device,
between the CUDA events the benchmark records at the entry and the exit
of the store's ``CudaServer.step_`` (the optimizer over every tensor)."""

import statistics


def read(run):
    return statistics.median(run.apply_ms) if run.apply_ms else None
