"""ps_tpu_torch — the PyTorch/CUDA port of ps_tpu, for NVIDIA H100s.

A second package beside ``ps_tpu`` (the JAX reference, unchanged): the
same ``init(backend=...)`` → ``KVStore`` / ``SparseEmbedding`` →
``make_composite_step`` API and the same numerics, in PyTorch. Where
``ps_tpu`` has a Pallas kernel for the TPU, the port has a kernel written
by hand for Hopper (``ops/csrc/``), built with ``nvcc`` at first use.

Ported so far, on one device: the Wide-&-Deep composite step, with the
fused sparse apply as a CUDA kernel; BERT MLM with server-side LAMB,
whose ``attn='flash'`` runs the flash-attention forward as a CUDA kernel;
and ResNet-50 sync data-parallel training with server-side momentum SGD
(``models/resnet.py``, ``examples/train_resnet50.py``), whose path
reaches no Pallas kernel in the reference and so runs cuDNN and PyTorch
ops, fed by the prefetched input path (``data/prefetch.py``,
``data/files.py``); the local parameter server (``backend='local'``,
``backends/local.py``) with the per-key push/pull protocol and the MNIST
MLP (``models/mlp.py``, ``examples/train_mnist_mlp.py``); and async
DC-ASGD in one process (``mode='async'`` on either backend,
``KVStore.make_async_step``, ``examples/train_mnist_async.py``). These
last two reach no Pallas kernel in the reference either. Checkpoint and
resume on one device (``checkpoint``, ``KVStore.save``/``restore``,
``SparseEmbedding.save``/``restore``) cover every engine, and
``checkpoint.from_reference`` converts a ``ps_tpu`` checkpoint. ``shutdown``
tears the backend down (``abort=True`` after a failure). ROADMAP.md lists
what is still to port.
"""

from ps_tpu_torch import checkpoint
from ps_tpu_torch.config import Config
from ps_tpu_torch.api import init, shutdown, is_initialized, current_context
from ps_tpu_torch.kv.store import KVStore
from ps_tpu_torch.kv.sparse import SparseEmbedding
from ps_tpu_torch.train import make_composite_step
from ps_tpu_torch.ops import flash_attention

__all__ = [
    "checkpoint",
    "Config",
    "init",
    "shutdown",
    "is_initialized",
    "current_context",
    "KVStore",
    "SparseEmbedding",
    "make_composite_step",
    "flash_attention",
]
