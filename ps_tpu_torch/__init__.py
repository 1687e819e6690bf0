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
tears the backend down (``abort=True`` after a failure).

Across the ranks of a ``torch.distributed`` process group
(``init(coordinator_uri=..., num_processes=k, process_id=r)`` or the
reference's ``PS_*`` variables; ``parallel/``): the sync server
replicated or ZeRO-1 sharded, row-sharded sparse tables with the
``gather`` and ``a2a`` exchanges, the composite step, cross-rank
BatchNorm, and the multi-process checkpoint commit with the elastic
restore, with a heartbeat failure detector (``control/``,
``CudaBackend.check_health``). The mesh takes the reference's 'model',
'seq' and 'pipe' axes too: ``partition_rules`` with Megatron BERT
(``--model-axis``), ring and Ulysses attention, GPipe, and the
long-context causal LM (``models/lm.py``,
``examples/train_longctx_lm.py``).

Across processes over the native TCP van (``native/``, ``control/``,
``backends/van_service.py``, ``backends/remote_async.py``): async DC-ASGD
with a server process (``serve_async``, one server or ``shard_tree``
key shards) and worker processes (``connect_async``), serial or bucketed,
on the reference's wire bytes; and the sparse PS of range-sharded
embedding tables (``backends/remote_sparse.py``): ``serve_sparse`` in
each server process, its tables on the card and every push applied by
the sparse-apply kernel, ``connect_sparse`` in the workers; and
two-level aggregation (``backends/aggregator.py``): ``serve_aggregator``
pre-reduces a host group's pushes into one upstream push a round, and
``connect_async(..., aggregator=...)`` routes a worker through it, with
the flat path as its fallback; and elastic membership (``elastic/``): a
``Coordinator`` holds the shard table, servers and workers given
``coordinator=`` join it, and key ranges move between live shards
(``elastic.request_rebalance``). ROADMAP.md lists what is still to port.
"""

from ps_tpu_torch import checkpoint
from ps_tpu_torch.config import Config
from ps_tpu_torch.api import init, shutdown, is_initialized, current_context
from ps_tpu_torch.kv.store import KVStore
from ps_tpu_torch.kv.sparse import SparseEmbedding
from ps_tpu_torch.train import make_composite_step
from ps_tpu_torch.ops import flash_attention
from ps_tpu_torch.backends.aggregator import AggregatorService, serve_aggregator
from ps_tpu_torch.backends.remote_async import (
    ServerFailureError,
    connect_async,
    serve_async,
    shard_tree,
)
from ps_tpu_torch.backends.remote_sparse import connect_sparse, serve_sparse
from ps_tpu_torch import elastic

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
    "serve_async",
    "connect_async",
    "shard_tree",
    "serve_aggregator",
    "AggregatorService",
    "serve_sparse",
    "connect_sparse",
    "ServerFailureError",
    "elastic",
]
