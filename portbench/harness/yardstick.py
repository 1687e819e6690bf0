"""The yardstick: the card's peaks, and the operations and bytes that a
step or a kernel call needs, worked out from shapes.

The peaks are NVIDIA's data sheet for the H100
(https://www.nvidia.com/en-us/data-center/h100/), dense rates without
sparsity, as ``ps_tpu_torch/utils/chips.py`` has them; a card is looked
up by a substring of ``torch.cuda.get_device_name()``, the narrower names
first. An unknown card gives None, and a share of its peak is then not
reported.
"""

from __future__ import annotations

from typing import Optional

# dense bf16 TFLOP/s, and HBM GB/s
PEAK_BF16_TFLOPS = {"h100 pcie": 756.0, "h100 nvl": 835.0, "h100": 989.0}
PEAK_HBM_GBPS = {"h100 pcie": 2000.0, "h100 nvl": 3900.0, "h100": 3350.0}


def _lookup(table, name: str) -> Optional[float]:
    name = name.lower()
    for sub, val in table.items():
        if sub in name:
            return val
    return None


def peak_bf16_flops(name: str) -> Optional[float]:
    """The card's dense bf16 peak in FLOP/s, or None."""
    v = _lookup(PEAK_BF16_TFLOPS, name)
    return None if v is None else v * 1e12


def peak_hbm_bytes(name: str) -> Optional[float]:
    """The card's HBM bandwidth in bytes/s, or None."""
    v = _lookup(PEAK_HBM_GBPS, name)
    return None if v is None else v * 1e9


# -- BERT ------------------------------------------------------------------------


def bert_macs_per_token(cfg: dict, seq: int) -> int:
    """Multiply-adds of one token's forward: every dense layer (query, key,
    value, output, the two feed-forward layers), the MLM transform and the
    tied decoder at every position, and the token's row of QKᵀ and of PV
    over ``seq`` keys."""
    H, inter = cfg["hidden_size"], cfg["intermediate_size"]
    layer = 4 * H * H + 2 * H * inter + 2 * seq * H
    head = H * H + H * cfg["vocab_size"]
    return cfg["num_hidden_layers"] * layer + head


def bert_step_flops(cfg: dict, batch: int, seq: int) -> int:
    """Model FLOPs of a training step: 3 x 2 x the forward's multiply-adds
    (the backward counted as twice the forward; recomputation not
    counted)."""
    return 6 * bert_macs_per_token(cfg, seq) * batch * seq


# -- ResNet ------------------------------------------------------------------------


def resnet_forward_macs(cfg: dict, image_size: int) -> int:
    """Multiply-adds of one forward of one square image: every convolution
    at its output size, and the classifier ('SAME' output sizes,
    ``ceil(n / stride)``; the 3x3/2 max pool after the stem)."""
    f0, cin = cfg["num_filters"], cfg["in_channels"]
    size = -(-image_size // 2)
    macs = size * size * f0 * cin * 7 * 7
    size = -(-size // 2)
    features = f0
    for i, n in enumerate(cfg["stage_sizes"]):
        f = f0 * 2 ** i
        for j in range(n):
            stride = 2 if i > 0 and j == 0 else 1
            out = -(-size // stride)
            macs += size * size * f * features          # 1x1
            macs += out * out * f * f * 9               # 3x3, strided
            macs += out * out * 4 * f * f               # 1x1
            if features != 4 * f or stride != 1:
                macs += out * out * 4 * f * features    # projection
            size, features = out, 4 * f
    return macs + features * cfg["num_classes"]


def resnet_step_flops(cfg: dict, batch: int, image_size: int) -> int:
    """Model FLOPs of a training step: 3 x 2 x the forward's multiply-adds
    x the batch."""
    return 6 * resnet_forward_macs(cfg, image_size) * batch


# -- the flash-attention forward ------------------------------------------------


def flash_fwd_cost(bh: int, seq: int, d: int, dtype_bytes: int,
                   mask_rows: int, causal: bool = False):
    """``(flops, bytes)`` one forward call needs: 2 x 2 x bh x seq² x d
    for QKᵀ and PV (half under a causal mask), each input byte read once
    (q, k, v, and the int32 mask ``[mask_rows, seq]``) and each output byte
    written once (out in the inputs' type, and the f32 log-sum-exp)."""
    flops = 4 * bh * seq * seq * d // (2 if causal else 1)
    nbytes = (4 * bh * seq * d * dtype_bytes + 4 * bh * seq
              + 4 * mask_rows * seq)
    return flops, nbytes


def roofline_seconds(flops: float, nbytes: float, card: str):
    """The least time the card could take for the work: the larger of
    operations over the bf16 peak and bytes over the HBM bandwidth, with
    which of the two bounds it (None where the card is unknown)."""
    pf, pb = peak_bf16_flops(card), peak_hbm_bytes(card)
    if pf is None or pb is None:
        return None, None
    t_ops, t_bytes = flops / pf, nbytes / pb
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
