"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version and a launch counter. So far: the fused sparse embedding
update (ops/sparse_apply.py)."""
