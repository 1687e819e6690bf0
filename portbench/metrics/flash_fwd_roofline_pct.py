"""``flash_fwd_roofline_pct``: the hand-written flash-attention forward's
share of its roofline: the least time the card could take for one call
(the larger of its operations over the bf16 peak and its bytes over the
HBM bandwidth, each input byte read once and each output byte written
once) over the call's mean device time, from the kernels named
``flash_fwd*`` in the traced window. The call's shape is the cell's:
``[batch x heads, seq, hidden / heads]`` in the compute type."""

from portbench.harness import yardstick

_BYTES = {"bfloat16": 2, "float32": 4}


def read(run):
    if run.timeline is None:
        return None
    times = [e - s for s, e, name in run.timeline.kernels()
             if "flash_fwd" in name]
    if not times:
        return None
    cfg, traffic = run.cell.config, run.cell.traffic
    heads = cfg["num_attention_heads"]
    flops, nbytes = yardstick.flash_fwd_cost(
        traffic["batch"] * heads, traffic["seq_len"],
        cfg["hidden_size"] // heads, _BYTES[cfg["compute_dtype"]],
        traffic["batch"])
    bound, _ = yardstick.roofline_seconds(flops, nbytes, run.card)
    if bound is None:
        return None
    return 100.0 * bound / (sum(times) / len(times) / 1e9)
