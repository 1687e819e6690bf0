"""BERT masked-LM pre-training on ``ps_tpu_torch``: ``BertMLM`` with
``make_mlm_loss_fn``, through ``KVStore(<the configuration's
optimizer>).make_step``, after ``ps_tpu_torch.init(backend="cuda")``.

The model is built as the port's trainer builds it, drawing its own
weights on the CPU; the step takes its parameters from the store
(``functional_call``), and the store holds the weights the benchmark
made from the seed, so the model's own draw serves no request (a program
change could build the model without it). Built on the meta device
instead, the first draw imports ``torch._dynamo`` (``torch._refs``),
which takes longer.
"""

from __future__ import annotations

import torch

from portbench.harness import yardstick
from portbench.harness.program import Program, flatten, nest

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def port_config(cfg: dict):
    from ps_tpu_torch.models.bert import BertConfig

    return BertConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_len=cfg["max_position_embeddings"],
        type_vocab_size=cfg["type_vocab_size"],
        dtype=DTYPES[cfg["compute_dtype"]], attn=cfg["attention"])


def kernels(cfg: dict):
    """The port's hand-written kernels this configuration's step runs."""
    return ("flash_attention",) if cfg["attention"] == "flash" else ()


def build(cfg: dict, params, state, device) -> Program:
    import ps_tpu_torch as ps
    from ps_tpu_torch.models.bert import BertMLM, make_mlm_loss_fn

    model = BertMLM(port_config(cfg), generator=torch.Generator().manual_seed(0))
    own = {k: tuple(v.shape) for k, v in flatten(model.param_tree()).items()}
    given = {k: tuple(v.shape) for k, v in params.items()}
    if own != given:
        raise ValueError(f"the port's BERT parameters differ from the "
                         f"benchmark's: {sorted(set(own.items()) ^ set(given.items()))[:4]}")
    ps.init(backend="cuda", device=str(device))
    opt = dict(cfg["optimizer"])
    store = ps.KVStore(optimizer=opt.pop("name"), **opt)
    store.init(nest(params))
    run = store.make_step(make_mlm_loss_fn(model))

    def call(batch, aux):
        loss, _ = run(batch)
        return loss, aux

    return Program(store, call, None, cfg["optimizer"])


def step_flops(cfg: dict, traffic: dict) -> int:
    return yardstick.bert_step_flops(cfg, traffic["batch"],
                                     traffic["seq_len"])
