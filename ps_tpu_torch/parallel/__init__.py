"""The multi-device layer of the port: a mesh over one
``torch.distributed`` process group (:mod:`.mesh`), byte-accounted
collectives (:mod:`.collectives`) and the placement policy
(:mod:`.sharding`). Counterpart of ``ps_tpu/parallel/`` for the 'data'
axis; tensor, sequence and pipeline parallelism are ROADMAP Queue 1
item 7."""
