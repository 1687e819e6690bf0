"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version and a launch counter: the fused sparse embedding update
(ops/sparse_apply.py), the flash-attention forward
(ops/flash_attention.py) and the fused multi-tensor LAMB step
(ops/lamb_apply.py, whose plain version is ``optim.lamb``'s loop)."""

from ps_tpu_torch.ops.flash_attention import flash_attention

__all__ = ["flash_attention"]
