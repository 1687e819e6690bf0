"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version and a launch counter: the fused sparse embedding update
(ops/sparse_apply.py) and the flash-attention forward
(ops/flash_attention.py)."""

from ps_tpu_torch.ops.flash_attention import flash_attention

__all__ = ["flash_attention"]
