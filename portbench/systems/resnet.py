"""ResNet training with BatchNorm on ``ps_tpu_torch``: ``ResNet`` of
bottleneck blocks with ``make_loss_fn(label_smoothing)``, through
``KVStore(<the configuration's optimizer>).make_step(has_aux=True)``,
after ``ps_tpu_torch.init(backend="cuda")``. The running statistics
thread through the step as its aux state.
"""

from __future__ import annotations

import torch

from portbench.harness import yardstick
from portbench.harness.program import Program, nest

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def port_model(cfg: dict):
    from ps_tpu_torch.models.resnet import BottleneckBlock, ResNet

    if cfg["block"] != "bottleneck":
        raise ValueError(f"block {cfg['block']!r}: the harness builds "
                         f"bottleneck ResNets")
    return ResNet(stage_sizes=tuple(cfg["stage_sizes"]),
                  block_cls=BottleneckBlock, num_classes=cfg["num_classes"],
                  num_filters=cfg["num_filters"],
                  dtype=DTYPES[cfg["compute_dtype"]])


def kernels(cfg: dict):
    """The port's hand-written kernels this configuration's step runs."""
    return ()


def build(cfg: dict, params, state, device) -> Program:
    import ps_tpu_torch as ps
    from ps_tpu_torch.models.resnet import make_loss_fn

    model = port_model(cfg)
    own_p, own_s = model.shapes(cfg["in_channels"])
    for own, given, what in ((own_p, params, "parameters"),
                             (own_s, state, "running statistics")):
        given = {k: tuple(v.shape) for k, v in given.items()}
        if dict(own) != given:
            raise ValueError(f"the port's ResNet {what} differ from the "
                             f"benchmark's: "
                             f"{sorted(set(own.items()) ^ set(given.items()))[:4]}")
    ps.init(backend="cuda", device=str(device))
    opt = dict(cfg["optimizer"])
    store = ps.KVStore(optimizer=opt.pop("name"), **opt)
    store.init(nest(params))
    run = store.make_step(make_loss_fn(model, cfg["label_smoothing"],
                                       mesh=store.mesh), has_aux=True)

    def call(batch, aux):
        loss, _, aux = run(batch, aux)
        return loss, aux

    stats = nest({k: v.clone() for k, v in state.items()})
    return Program(store, call, stats, cfg["optimizer"])


def step_flops(cfg: dict, traffic: dict) -> int:
    return yardstick.resnet_step_flops(cfg, traffic["batch"],
                                       traffic["image_size"])
