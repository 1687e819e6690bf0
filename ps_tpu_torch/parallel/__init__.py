"""The multi-device layer of the port: a mesh of named axes over one
``torch.distributed`` process group (:mod:`.mesh`: 'data', 'model',
'seq', 'pipe'), byte-accounted collectives over one axis each, with the
autograd forms a parallel forward needs (:mod:`.collectives`), the
placement policy with the reference's partition rules (:mod:`.sharding`),
sequence parallelism by ring and Ulysses attention
(:mod:`.ring_attention`) and GPipe over 'pipe' (:mod:`.pipeline`).
Counterpart of ``ps_tpu/parallel/``."""

from ps_tpu_torch.parallel.pipeline import (
    make_pipeline_fn,
    microbatch,
    pipeline_partition_rules,
    stack_stage_params,
)
from ps_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ulysses_attention,
)

__all__ = [
    "ring_attention",
    "ulysses_attention",
    "make_pipeline_fn",
    "microbatch",
    "pipeline_partition_rules",
    "stack_stage_params",
]
