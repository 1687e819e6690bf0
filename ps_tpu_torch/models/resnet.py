"""ResNet — the reference's workload config 2 (ResNet-50 / ImageNet, sync
data-parallel).

Counterpart of ``ps_tpu/models/resnet.py``: ResNet v1.5 over NHWC images,
bf16 compute over f32 parameters, with flax's numerics carried over:

- ``padding='SAME'`` as flax computes it: a pad total of ``max((⌈n/s⌉-1)·s
  + k - n, 0)`` with the smaller half before, so a stride-2 layer on an even
  input pads (0, 1) and the 7x7/2 stem on 224 pads (2, 3); where the halves
  differ the input is padded with ``F.pad`` and the op pads nothing. The
  3x3/2 max pool pads the same way, with -inf;
- a convolution or the head casts its input and its f32 kernel to the
  compute type and multiplies there (flax's ``promote_dtype``); the head
  adds its bias in the compute type and the logits are cast to f32; the
  global mean pool runs in the compute type over f32 sums;
- BatchNorm (momentum 0.9, eps 1e-5): batch statistics in f32 with flax's
  fast variance (``var = max(0, E[x²] - E[x]²)``), the output ``(x - mean)
  · (rsqrt(var + eps) · scale) + bias`` in f32, then cast to the compute
  type; the running statistics become ``0.9·old + 0.1·batch`` with the
  biased variance. Its backward saves only the input, in the compute type,
  and per-channel f32 statistics. Across ranks the statistics are the
  global batch's (cross-rank BatchNorm, :class:`_BatchNormTrain`), as
  the reference's GSPMD BatchNorm takes them;
- with ``dtype=torch.float32`` every convolution runs in full f32 on the
  card, forward and backward (cuDNN would take TF32 by default), under a
  setting scoped to the model.

Layout: the NHWC batch is permuted to an NCHW view, which is
``torch.channels_last`` in memory (no copy). Kernels are OIHW, kept
channels_last (flax's are HWIO), the head's kernel ``[out, in]`` (flax's
``[in, out]``). Keys are flax's paths (``conv_init``, ``bn_init``,
``BottleneckBlock_<i>/Conv_<j>``, ``BatchNorm_<j>``, ``conv_proj``,
``norm_proj``, ``head``), so a KVStore registers the reference's key
strings in its order.

The model is functional, as flax's is: :meth:`ResNet.init` returns
``(params, batch_stats)`` nested dicts and :meth:`ResNet.apply` returns the
logits and the new ``batch_stats``, which the train step threads through
as aux state (:func:`make_loss_fn`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ps_tpu_torch.kv import keys as keymod
from ps_tpu_torch.models.draws import lecun_normal
from ps_tpu_torch.parallel import collectives

_BN_MOMENTUM = 0.9
_BN_EPS = 1e-5


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax's (XLA's) 'SAME' padding of one spatial axis: (before, after)."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, kernel: int, stride: int, value: float = 0.0):
    """``x`` [N, C, H, W] padded as 'SAME' pads it, and the symmetric
    padding still left for the op to apply."""
    (top, bottom), (left, right) = (same_pads(n, kernel, stride)
                                    for n in x.shape[2:])
    if top == bottom and left == right:
        return x, (top, left)
    return F.pad(x, (left, right, top, bottom), value=value), (0, 0)


@contextlib.contextmanager
def _full_f32():
    """cuDNN convolutions and CUDA products in full f32 inside; the flags
    are put back as they were on the way out."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


class _Conv(torch.autograd.Function):
    """A bias-free conv2d whose forward and backward both run under
    :func:`_full_f32` (autograd runs a backward outside the forward's
    scope)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        with _full_f32():
            return F.conv2d(x, w, None, stride, padding)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        with _full_f32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, [ctx.stride] * 2, list(ctx.padding), [1, 1],
                False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None


def _normalize(x, mean, var, scale, bias):
    """flax's ``_normalize``: ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias`` in f32 (``x - mean`` promotes a bf16 ``x``), cast to x's type."""
    c = (1, -1, 1, 1)
    mul = torch.rsqrt(var + _BN_EPS) * scale
    return ((x - mean.view(c)) * mul.view(c) + bias.view(c)).to(x.dtype)


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode BatchNorm over [N, C, H, W]: returns the output and the
    batch's f32 mean and biased variance. Saves the input (in its own type)
    and per-channel statistics; the backward is the batch-norm gradient
    (PyTorch's ``native_batch_norm_backward`` with this forward's mean and
    1/std), which equals flax's with the variance above 0.

    Across the ranks of ``mesh`` the statistics are the global batch's, as
    the reference's BatchNorm takes them over the sharded global batch
    (GSPMD reduces its means over the mesh): the forward all-reduces the
    f32 per-channel ``[Σx, Σx²]`` and the element count before it forms
    the mean and the variance by flax's formula, and the backward
    all-reduces the two per-channel sums the input's gradient needs
    (``Σgy`` and ``Σgy·(x - mean)``); the scale's and the bias's gradients
    stay this rank's sums, which the server's reduction averages."""

    @staticmethod
    def forward(ctx, x, scale, bias, mesh):
        xf = x.float()
        if mesh is None:
            mean = xf.mean((0, 2, 3))
            var = torch.clamp_min(torch.square(xf).mean((0, 2, 3))
                                  - torch.square(mean), 0.0)
        else:
            c = x.shape[1]
            sums = torch.cat([xf.sum((0, 2, 3)),
                              torch.square(xf).sum((0, 2, 3)),
                              xf.new_full((1,), x.numel() // c)])
            collectives.all_reduce(sums, mesh)
            ctx.count = sums[2 * c]
            mean = sums[:c] / ctx.count
            var = torch.clamp_min(sums[c:2 * c] / ctx.count
                                  - torch.square(mean), 0.0)
        del xf
        y = _normalize(x, mean, var, scale, bias)
        ctx.save_for_backward(x, scale, mean, torch.rsqrt(var + _BN_EPS))
        ctx.mesh = mesh
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, scale, mean, rstd = ctx.saved_tensors
        if ctx.mesh is None:
            gx, gscale, gbias = torch.ops.aten.native_batch_norm_backward(
                gy, x, scale, None, None, mean, rstd, True, _BN_EPS,
                list(ctx.needs_input_grad[:3]))
            return gx, gscale, gbias, None
        c, shape = x.shape[1], (1, -1, 1, 1)
        gyf = gy.float()
        xmu = x.float() - mean.view(shape)
        sums = torch.cat([gyf.sum((0, 2, 3)), (gyf * xmu).sum((0, 2, 3))])
        gbias, gscale = sums[:c].clone(), sums[c:] * rstd
        collectives.all_reduce(sums, ctx.mesh)
        mean_dy, mean_dy_xmu = sums[:c] / ctx.count, sums[c:] / ctx.count
        gx = ((gyf - mean_dy.view(shape)
               - xmu * (rstd * rstd * mean_dy_xmu).view(shape))
              * (rstd * scale).view(shape))
        return gx.to(x.dtype), gscale, gbias, None


class _Scope:
    """One module's parameters and batch statistics during a forward, and
    the statistics it produces — what a flax scope holds."""

    def __init__(self, params, stats, train: bool, dtype, new_stats=None,
                 mesh=None):
        self.params, self.stats = params, stats
        self.train, self.dtype = train, dtype
        self.new_stats = {} if new_stats is None else new_stats
        self.mesh = mesh  # the ranks BatchNorm reduces over, or None

    def child(self, name: str) -> "_Scope":
        return _Scope(self.params[name], self.stats[name], self.train,
                      self.dtype, self.new_stats.setdefault(name, {}),
                      self.mesh)

    def conv(self, name: str, x, stride: int = 1):
        """flax ``Conv(use_bias=False, padding='SAME')`` in the compute
        type."""
        w = self.params[name]["kernel"].to(self.dtype,
                                           memory_format=torch.channels_last)
        x, padding = _pad_same(x, w.shape[-1], stride)
        return _Conv.apply(x, w, stride, padding)

    def norm(self, name: str, x):
        """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)``."""
        p, s = self.params[name], self.stats[name]
        if not self.train:
            self.new_stats[name] = s
            return _normalize(x, s["mean"], s["var"], p["scale"], p["bias"])
        y, mean, var = _BatchNormTrain.apply(x, p["scale"], p["bias"],
                                             self.mesh)
        self.new_stats[name] = {
            "mean": _BN_MOMENTUM * s["mean"] + (1 - _BN_MOMENTUM) * mean,
            "var": _BN_MOMENTUM * s["var"] + (1 - _BN_MOMENTUM) * var}
        return y


def _max_pool_same(x):
    """flax ``max_pool(x, (3, 3), strides=(2, 2), padding='SAME')``."""
    x, padding = _pad_same(x, 3, 2, value=-math.inf)
    return F.max_pool2d(x, 3, 2, padding)


@dataclasses.dataclass(frozen=True)
class BasicBlock:
    """Two 3x3 convs — the ResNet-18/34 block."""

    filters: int
    strides: int = 1

    def variables(self, features: int):
        """``({conv: (OIHW shape, stride)}, {norm: (features, scale
        init)}, output features)`` for an input of ``features``."""
        f = self.filters
        convs = {"Conv_0": ((f, features, 3, 3), self.strides),
                 "Conv_1": ((f, f, 3, 3), 1)}
        norms = {"BatchNorm_0": (f, 1.0), "BatchNorm_1": (f, 0.0)}
        if features != f or self.strides != 1:
            convs["conv_proj"] = ((f, features, 1, 1), self.strides)
            norms["norm_proj"] = (f, 1.0)
        return convs, norms, f

    def __call__(self, scope: _Scope, x):
        residual = x
        y = F.relu(scope.norm("BatchNorm_0",
                              scope.conv("Conv_0", x, self.strides)))
        y = scope.norm("BatchNorm_1", scope.conv("Conv_1", y))
        if "conv_proj" in scope.params:
            residual = scope.norm("norm_proj", scope.conv(
                "conv_proj", residual, self.strides))
        return F.relu(residual + y)


@dataclasses.dataclass(frozen=True)
class BottleneckBlock:
    """1x1 → 3x3 → 1x1 bottleneck — the ResNet-50/101/152 block (v1.5: the
    stride lives on the 3x3); the last BN's scale starts at 0."""

    filters: int
    strides: int = 1

    def variables(self, features: int):
        f = self.filters
        convs = {"Conv_0": ((f, features, 1, 1), 1),
                 "Conv_1": ((f, f, 3, 3), self.strides),
                 "Conv_2": ((4 * f, f, 1, 1), 1)}
        norms = {"BatchNorm_0": (f, 1.0), "BatchNorm_1": (f, 1.0),
                 "BatchNorm_2": (4 * f, 0.0)}
        if features != 4 * f or self.strides != 1:
            convs["conv_proj"] = ((4 * f, features, 1, 1), self.strides)
            norms["norm_proj"] = (4 * f, 1.0)
        return convs, norms, 4 * f

    def __call__(self, scope: _Scope, x):
        residual = x
        y = F.relu(scope.norm("BatchNorm_0", scope.conv("Conv_0", x)))
        y = F.relu(scope.norm("BatchNorm_1",
                              scope.conv("Conv_1", y, self.strides)))
        y = scope.norm("BatchNorm_2", scope.conv("Conv_2", y))
        if "conv_proj" in scope.params:
            residual = scope.norm("norm_proj", scope.conv(
                "conv_proj", residual, self.strides))
        return F.relu(residual + y)


def _nest(flat: Dict[str, object]) -> dict:
    """``{"a/b": v}`` → ``{"a": {"b": v}}``."""
    tree: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


@dataclasses.dataclass(frozen=True)
class ResNet:
    """Generic ResNet over NHWC inputs.

    Attributes:
      stage_sizes: blocks per stage, e.g. (3, 4, 6, 3) for ResNet-50.
      block_cls: BasicBlock or BottleneckBlock.
      num_classes: classifier width.
      num_filters: stem width (64 for the standard family).
      dtype: compute dtype (bf16 by default; parameters stay f32).
      small_inputs: a 3x3/stride-1 stem and no max pool, for CIFAR-sized
        images (tests and tiny runs).
    """

    stage_sizes: Sequence[int]
    block_cls: type
    num_classes: int = 1000
    num_filters: int = 64
    dtype: torch.dtype = torch.bfloat16
    small_inputs: bool = False

    def blocks(self):
        """``[(flax name, block)]`` in forward order."""
        out = []
        for i, num_blocks in enumerate(self.stage_sizes):
            for j in range(num_blocks):
                block = self.block_cls(self.num_filters * 2 ** i,
                                       2 if i > 0 and j == 0 else 1)
                out.append((f"{self.block_cls.__name__}_{len(out)}", block))
        return out

    def variables(self, in_channels: int = 3):
        """``({conv path: (OIHW shape, stride)}, {norm path: (features,
        scale init)}, head (in, out))`` — every variable's flax path and
        shape in the port's layout."""
        stem = 3 if self.small_inputs else 7
        convs = {"conv_init": ((self.num_filters, in_channels, stem, stem),
                               1 if self.small_inputs else 2)}
        norms = {"bn_init": (self.num_filters, 1.0)}
        features = self.num_filters
        for name, block in self.blocks():
            c, n, features = block.variables(features)
            convs.update({f"{name}/{k}": v for k, v in c.items()})
            norms.update({f"{name}/{k}": v for k, v in n.items()})
        return convs, norms, (features, self.num_classes)

    def shapes(self, in_channels: int = 3):
        """``({param key: shape}, {batch_stats key: shape})`` in the port's
        layout."""
        convs, norms, (n_in, n_out) = self.variables(in_channels)
        params = {f"{k}/kernel": s for k, (s, _) in convs.items()}
        params.update({"head/kernel": (n_out, n_in), "head/bias": (n_out,)})
        stats = {}
        for k, (n, _) in norms.items():
            params[f"{k}/scale"] = params[f"{k}/bias"] = (n,)
            stats[f"{k}/mean"] = stats[f"{k}/var"] = (n,)
        return params, stats

    def init(self, generator: torch.Generator = None, in_channels: int = 3,
             device=None):
        """``(params, batch_stats)`` drawn as flax draws them: lecun_normal
        kernels, zero biases, BN scale 1 (0 on each block's last BN),
        running mean 0 and variance 1. Drawn on the CPU in key order, so a
        generator's seed gives the same weights on any device."""
        _, norms, _ = self.variables(in_channels)
        shapes, stat_shapes = self.shapes(in_channels)
        params = {}
        for key in sorted(shapes):
            shape = shapes[key]
            if key.endswith("kernel"):  # lecun_normal over the fan-in
                t = lecun_normal(shape, math.prod(shape[1:]), generator)
            elif key.endswith("scale"):
                t = torch.full(shape, norms[key[:-len("/scale")]][1])
            else:
                t = torch.zeros(shape)
            params[key] = t
        stats = {k: (torch.ones if k.endswith("var") else torch.zeros)(s)
                 for k, s in stat_shapes.items()}
        return self._place(params, device), self._place(stats, device)

    @staticmethod
    def _place(flat, device):
        return _nest({k: (t.to(device, memory_format=torch.channels_last)
                          if t.dim() == 4 else t.to(device))
                      for k, t in flat.items()})

    def params_from_jax(self, params, batch_stats, device=None):
        """The reference's ``params`` and ``batch_stats`` (as flax's init
        gives them, nested or ``{key: array}``, numpy), in the port's
        layout: conv kernels HWIO → OIHW, the head's ``[in, out]`` →
        ``[out, in]``, the rest as it is. Returns ``(params,
        batch_stats)``; a key or shape that does not fit raises."""
        flat, _ = keymod.flatten_with_keys(params)
        stats, _ = keymod.flatten_with_keys(batch_stats)
        own_p, own_s = self.shapes(np.shape(flat["conv_init/kernel"])[2])
        out = []
        for given, own in ((flat, own_p), (stats, own_s)):
            if set(given) != set(own):
                raise ValueError(f"keys {sorted(set(given) ^ set(own))} do "
                                 f"not match the model's variables")
            converted = {}
            for key, arr in given.items():
                t = torch.tensor(np.asarray(arr, np.float32))
                if t.dim() == 4:
                    t = t.permute(3, 2, 0, 1)
                elif key == "head/kernel":
                    t = t.t()
                if tuple(t.shape) != own[key]:
                    raise ValueError(f"{key}: shape {tuple(np.shape(arr))} "
                                     f"does not fit {own[key]}")
                converted[key] = t
            out.append(self._place(converted, device))
        return tuple(out)

    def apply(self, params, batch_stats, images, train: bool = True,
              mesh=None):
        """Logits ``[B, num_classes]`` (f32) for NHWC ``images`` and the
        new ``batch_stats`` (the given ones when ``train`` is False).
        With the ``mesh`` of more than one rank, ``images`` is this rank's
        slice of the global batch and training-mode BatchNorm takes the
        global batch's statistics (every rank must make the call); without
        it, the statistics are those of ``images``."""
        if mesh is not None and (mesh.group is None or mesh.size == 1):
            mesh = None
        scope = _Scope(params, batch_stats, train, self.dtype, mesh=mesh)
        with _full_f32():
            x = images.to(self.dtype).permute(0, 3, 1, 2)  # channels_last
            x = scope.conv("conv_init", x, 1 if self.small_inputs else 2)
            x = F.relu(scope.norm("bn_init", x))
            if not self.small_inputs:
                x = _max_pool_same(x)
            for name, block in self.blocks():
                x = block(scope.child(name), x)
            x = x.mean((2, 3))
            head = params["head"]
            x = (torch.matmul(x, head["kernel"].to(self.dtype).t())
                 + head["bias"].to(self.dtype))
        return x.float(), scope.new_stats

    def forward_macs(self, image_size: int, in_channels: int = 3) -> int:
        """Multiply-adds of one forward for one square image: every
        convolution at its output size, and the head."""
        convs, _, (n_in, n_out) = self.variables(in_channels)
        shape, stride = convs["conv_init"]
        size = -(-image_size // stride)
        macs = size * size * math.prod(shape) + n_in * n_out
        if not self.small_inputs:
            size = -(-size // 2)  # the max pool
        features = self.num_filters
        for _, block in self.blocks():
            block_convs, _, features = block.variables(features)
            at = size  # the main path's size; conv_proj reads the input
            for key, (shape, stride) in block_convs.items():
                out = -(-(size if key == "conv_proj" else at) // stride)
                macs += out * out * math.prod(shape)
                if key != "conv_proj":
                    at = out
            size = at
        return macs


ResNet18 = functools.partial(ResNet, stage_sizes=(2, 2, 2, 2),
                             block_cls=BasicBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=(3, 4, 6, 3),
                             block_cls=BasicBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=(3, 4, 6, 3),
                             block_cls=BottleneckBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=(3, 4, 23, 3),
                              block_cls=BottleneckBlock)
ResNet152 = functools.partial(ResNet, stage_sizes=(3, 8, 36, 3),
                              block_cls=BottleneckBlock)


def make_loss_fn(model: ResNet, label_smoothing: float = 0.0, mesh=None):
    """PS-step loss closure for a BatchNorm model:
    ``loss_fn(params, batch, model_state) -> (loss, new_model_state)`` for
    ``KVStore.make_step(loss_fn, has_aux=True)``; ``batch`` is ``(images,
    labels)`` and the ``batch_stats`` thread through as aux state. With
    the store's ``mesh`` (``KVStore.mesh``) BatchNorm takes the global
    batch's statistics across its ranks."""

    def loss_fn(params, batch, model_state):
        images, labels = batch
        logits, new_state = model.apply(params, model_state, images,
                                        train=True, mesh=mesh)
        return cross_entropy_loss(logits, labels, label_smoothing), new_state

    return loss_fn


def cross_entropy_loss(logits, labels, label_smoothing: float = 0.0):
    """Mean softmax cross-entropy over integer labels, in f32."""
    num_classes = logits.shape[-1]
    onehot = F.one_hot(labels.long(), num_classes).float()
    if label_smoothing:
        onehot = (onehot * (1.0 - label_smoothing)
                  + label_smoothing / num_classes)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(onehot * logp).sum(-1).mean()
