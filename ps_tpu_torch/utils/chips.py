"""Peak tables of the accelerators, for utilization and bound accounting.

Peaks come from public data sheets; they let a benchmark turn a measured
rate into a share of the card's peak, and a kernel's bytes or operations
into the least time the card could take for them. A card is looked up by
its name as ``torch.cuda.get_device_name`` gives it (a name string, a
``torch.device`` or a device index), or by an object's ``device_kind``
as the reference's TPU tables read it. The first row whose key is a
substring of the lowered name wins, so the narrower NVIDIA names come
before the bare "h100". An unknown card gives ``None``: the caller
reports the raw rate, never a made-up share.
"""

from __future__ import annotations

from typing import Optional

# Dense bf16 peak TFLOP/s per card. NVIDIA rows: the H100 data sheet,
# https://www.nvidia.com/en-us/data-center/h100/ (without sparsity).
PEAK_BF16_TFLOPS = {
    "h100 pcie": 756.0,
    "h100 nvl": 835.0,
    "h100": 989.0,  # SXM5, "NVIDIA H100 80GB HBM3"
    "v6e": 918.0,  # Trillium
    "v6": 918.0,
    "v5p": 459.0,
    "v5 lite": 197.0,  # v5e
    "v5e": 197.0,
    "v4": 275.0,
    "v3": 123.0,
    "v2": 45.0,
}

# HBM bandwidth GB/s per card (the same sheets).
PEAK_HBM_GBPS = {
    "h100 pcie": 2000.0,
    "h100 nvl": 3900.0,
    "h100": 3350.0,
    "v6e": 1640.0,
    "v6": 1640.0,
    "v5p": 2765.0,
    "v5 lite": 819.0,
    "v5e": 819.0,
    "v4": 1228.0,
    "v3": 900.0,
    "v2": 700.0,
}


def _name(device) -> str:
    """The name a card is looked up by: a string as given, an object's
    ``device_kind``, else ``torch.cuda.get_device_name(device)``."""
    if isinstance(device, str):
        return device
    kind = getattr(device, "device_kind", None)
    if kind is not None:
        return str(kind)
    import torch

    return torch.cuda.get_device_name(device)


def _lookup(table, device) -> Optional[float]:
    kind = _name(device).lower()
    for sub, val in table.items():
        if sub in kind:
            return val
    return None


def peak_bf16_tflops(device) -> Optional[float]:
    """Dense bf16 peak of the card, or None when the card is unknown."""
    return _lookup(PEAK_BF16_TFLOPS, device)


def peak_hbm_gbps(device) -> Optional[float]:
    """HBM bandwidth peak of the card, or None when unknown."""
    return _lookup(PEAK_HBM_GBPS, device)
