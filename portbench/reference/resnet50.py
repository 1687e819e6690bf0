"""The plain reference of ``resnet50``: ResNet-50 v1.5 (He et al. 2016; the
stride of each down-sampling block on its 3x3 convolution, as torchvision
and MLPerf take it) trained with BatchNorm in training mode and
label-smoothed cross-entropy, in float32 plain PyTorch.

The configuration's stated choices: images NHWC, 'SAME' padding as
TensorFlow and flax compute it (a pad total of ``max((ceil(n/s) - 1)·s +
k - n, 0)``, the smaller half before; torchvision pads symmetrically), a
3x3/2 max pool padded the same way with -inf, BatchNorm momentum 0.9 on
the running statistics (the running value keeps 0.9 of itself) with the
biased batch variance, eps 1e-5, each block's last BatchNorm scale
starting at 0 (Goyal et al. 2017), no bias on a convolution, and global
average pooling before the classifier.

Parameters: convolution kernels ``[out, in, kh, kw]`` under their
block's key (``BottleneckBlock_<i>/Conv_<j>/kernel``, ``conv_proj``,
``conv_init``), BatchNorm ``scale`` and ``bias`` (``BatchNorm_<j>``,
``norm_proj``, ``bn_init``), the classifier ``head/kernel`` ``[classes,
features]`` and ``head/bias``; the running statistics ``<norm>/mean`` and
``<norm>/var`` are the state. :func:`init_params` draws every kernel
from a normal truncated at two deviations with variance 1/fan-in
(LeCun's), zero biases, and a running mean of 0 and variance of 1.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import common

# the truncated unit normal's own deviation, divided out so the variance
# is 1/fan-in
_TRUNC_STD = 0.87962566103423978


def _blocks(cfg: dict) -> List[Tuple[str, int, int, int]]:
    """``(key, filters, stride, in_features)`` of every bottleneck block in
    forward order."""
    out, features = [], cfg["num_filters"]
    for i, n in enumerate(cfg["stage_sizes"]):
        for j in range(n):
            f = cfg["num_filters"] * 2 ** i
            stride = 2 if i > 0 and j == 0 else 1
            out.append((f"BottleneckBlock_{len(out)}", f, stride, features))
            features = 4 * f
    return out


def _convs_and_norms(cfg: dict):
    """``({conv key: (OIHW shape, stride)}, {norm key: (width, scale
    init)}, classifier (in, out))``."""
    f0, cin = cfg["num_filters"], cfg["in_channels"]
    convs = {"conv_init": ((f0, cin, 7, 7), 2)}
    norms = {"bn_init": (f0, 1.0)}
    features = f0
    for key, f, stride, features in _blocks(cfg):
        convs[f"{key}/Conv_0"] = ((f, features, 1, 1), 1)
        convs[f"{key}/Conv_1"] = ((f, f, 3, 3), stride)
        convs[f"{key}/Conv_2"] = ((4 * f, f, 1, 1), 1)
        norms[f"{key}/BatchNorm_0"] = (f, 1.0)
        norms[f"{key}/BatchNorm_1"] = (f, 1.0)
        norms[f"{key}/BatchNorm_2"] = (4 * f, 0.0 if cfg["zero_init_last_bn"]
                                       else 1.0)
        if features != 4 * f or stride != 1:
            convs[f"{key}/conv_proj"] = ((4 * f, features, 1, 1), stride)
            norms[f"{key}/norm_proj"] = (4 * f, 1.0)
    last = 4 * cfg["num_filters"] * 2 ** (len(cfg["stage_sizes"]) - 1)
    return convs, norms, (last, cfg["num_classes"])


def shapes(cfg: dict) -> Tuple[Dict[str, tuple], Dict[str, tuple]]:
    """``({param key: shape}, {state key: shape})``, keys sorted."""
    convs, norms, (n_in, n_out) = _convs_and_norms(cfg)
    params = {f"{k}/kernel": s for k, (s, _) in convs.items()}
    params["head/kernel"], params["head/bias"] = (n_out, n_in), (n_out,)
    state = {}
    for k, (n, _) in norms.items():
        params[f"{k}/scale"] = params[f"{k}/bias"] = (n,)
        state[f"{k}/mean"] = state[f"{k}/var"] = (n,)
    return dict(sorted(params.items())), dict(sorted(state.items()))


def init_params(cfg: dict, generator: torch.Generator, device
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``(params, state)`` drawn from ``generator`` on ``device`` in float32:
    one draw for every kernel, scaled leaf by leaf to its fan-in.
    Convolution kernels are laid out channels-last in memory."""
    _, norms, _ = _convs_and_norms(cfg)
    p_shapes, s_shapes = shapes(cfg)
    kernels = {k: s for k, s in p_shapes.items() if k.endswith("/kernel")}
    flat = common.truncated_normal(sum(math.prod(s) for s in kernels.values()),
                                   generator, device)
    params = {}
    for k, t in common.split_flat(flat, kernels).items():
        fan_in = math.prod(t.shape[1:])
        t.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)
        params[k] = (t.contiguous(memory_format=torch.channels_last)
                     if t.dim() == 4 else t)
    for k, s in p_shapes.items():
        if k.endswith("/scale"):
            params[k] = torch.full(s, norms[k[:-len("/scale")]][1],
                                   device=device)
        elif k not in params:
            params[k] = torch.zeros(s, device=device)
    state = {k: torch.full(s, 1.0 if k.endswith("/var") else 0.0,
                           device=device) for k, s in s_shapes.items()}
    return {k: params[k] for k in p_shapes}, state


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """'SAME' padding of one axis: (before, after)."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad(x, kernel, stride, value=0.0):
    """``x`` [N, C, H, W] padded as 'SAME' pads it, and the symmetric
    padding left for the op."""
    (t, b), (l, r) = (same_pads(n, kernel, stride) for n in x.shape[2:])
    if t == b and l == r:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


class _Forward:
    def __init__(self, cfg, p, state, prec):
        self.cfg, self.p, self.state, self.prec = cfg, p, state, prec
        self.new_state: Dict[str, torch.Tensor] = {}

    def conv(self, key, x, stride=1):
        w = self.p[f"{key}/kernel"]
        x, padding = _pad(x, w.shape[-1], stride)
        return self.prec.conv(x, w, stride, padding)

    def norm(self, key, x):
        mean = x.mean((0, 2, 3))
        var = x.var((0, 2, 3), unbiased=False)
        m = self.cfg["bn_momentum"]
        self.new_state[f"{key}/mean"] = (m * self.state[f"{key}/mean"]
                                         + (1 - m) * mean.detach())
        self.new_state[f"{key}/var"] = (m * self.state[f"{key}/var"]
                                        + (1 - m) * var.detach())
        c = (1, -1, 1, 1)
        y = (x - mean.view(c)) * torch.rsqrt(var + self.cfg["bn_eps"]).view(c)
        return (y * self.p[f"{key}/scale"].view(c)
                + self.p[f"{key}/bias"].view(c))

    def __call__(self, images):
        x = images.float().permute(0, 3, 1, 2)
        x = F.relu(self.norm("bn_init", self.conv("conv_init", x, 2)))
        x, padding = _pad(x, 3, 2, value=-math.inf)
        x = F.max_pool2d(x, 3, 2, padding)
        for key, _, stride, _ in _blocks(self.cfg):
            y = F.relu(self.norm(f"{key}/BatchNorm_0",
                                 self.conv(f"{key}/Conv_0", x)))
            y = F.relu(self.norm(f"{key}/BatchNorm_1",
                                 self.conv(f"{key}/Conv_1", y, stride)))
            y = self.norm(f"{key}/BatchNorm_2", self.conv(f"{key}/Conv_2", y))
            if f"{key}/conv_proj/kernel" in self.p:
                x = self.norm(f"{key}/norm_proj",
                              self.conv(f"{key}/conv_proj", x, stride))
            x = F.relu(x + y)
        x = x.mean((2, 3))
        return (self.prec.matmul(x, self.p["head/kernel"].t())
                + self.p["head/bias"])


def loss_fn(cfg: dict):
    """``loss(params, state, batch, precision) -> (loss, new state)``:
    label-smoothed cross-entropy (``label_smoothing`` of the
    configuration) over the batch's ``(images, labels)``."""

    def loss(p, state, batch, prec):
        images, labels = batch
        fwd = _Forward(cfg, p, state, prec)
        logits = fwd(images)
        return F.cross_entropy(logits, labels.long(),
                               label_smoothing=cfg["label_smoothing"]), \
            fwd.new_state

    return loss


def readings(cfg: dict, params, state, batches, precision: str = "float32"
             ) -> dict:
    """The readings of plain training from ``params`` and ``state`` over
    ``batches`` with the configuration's optimizer: see
    :func:`common.train_readings`."""
    return common.train_readings(loss_fn(cfg), params, state, batches,
                                 cfg["optimizer"],
                                 common.Precision(precision))
