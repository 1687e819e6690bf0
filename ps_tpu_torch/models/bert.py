"""BERT-base MLM — the reference's workload config 3 (dense grads +
server-side LAMB).

Counterpart of ``ps_tpu/models/bert.py``: a post-LN BERT encoder and a
tied-embedding MLM head, bf16 compute over f32 parameters, with flax's
numerics carried over:

- a Dense layer casts its input, kernel and bias to the compute type and
  multiplies there, then adds the bias (flax's ``promote_dtype``);
- the residual is added in the compute type, then LayerNorm runs in f32
  (eps 1e-12) and its output is cast back;
- GELU is the tanh form; the tied decoder ``x @ token_embed.T`` runs in
  f32 (flax promotes bf16 × f32), and the logits are f32;
- ``attn='full'`` is the plain einsum path (a -1e9 bias on padded keys,
  softmax in f32); ``attn='flash'`` goes through
  :func:`ps_tpu_torch.ops.flash_attention`, whose forward is the CUDA
  kernel on the card.

Parameters keep the reference's keys and layouts, one tensor per key
(``layer_0/attention/query/kernel`` ``[H, h, d]``, ``…/out/kernel``
``[h, d, H]``, Dense kernels ``[in, out]``, embeddings ``[V, H]``), so a
KVStore registers the same keys and LAMB's per-tensor trust ratios are the
reference's. Initial weights follow flax's distributions, drawn from a
``torch.Generator``.

Tensor parallelism over a 'model' axis (Megatron; the reference lets
GSPMD partition its one program): under :func:`bert_partition_rules` a
KVStore hands the forward each rank's slices of Q/K/V (column-parallel
over the heads, with their biases), ``attention/out`` (row-parallel),
``intermediate`` (column-parallel) and ``output`` (row-parallel), and
every other leaf whole (all-gathered over 'model'; vocab-parallel
embeddings are a feature the reference lacks). The forward sees the
slices by their shapes and, given the mesh, enters each parallel region
through ``f`` (identity forward, the gradient all-reduced over 'model')
and leaves it through ``g``: the row-parallel partial products, in the
compute type as one process's whole product, all-reduced over 'model'
in that type, then the whole bias added. ``attn='flash'`` runs the
kernel on the rank's ``h/m`` heads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ps_tpu_torch import obs
from ps_tpu_torch.kv import keys as keymod
from ps_tpu_torch.ops.flash_attention import flash_attention
from ps_tpu_torch.parallel import collectives
from ps_tpu_torch.parallel.mesh import MODEL_AXIS

# flax's lecun_normal draws a unit normal truncated to [-2, 2], rescaled by
# this constant (its standard deviation) so the variance is 1/fan_in
_TRUNC_STD = 0.87962566103423978
_LN_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_len: int = 512
    type_vocab_size: int = 2
    dtype: torch.dtype = torch.bfloat16
    # 'full' = explicit einsum attention; 'flash' = the fused kernel
    # (ps_tpu_torch/ops/flash_attention.py). Sequence length must be a
    # multiple of 128 for 'flash'.
    attn: str = "full"

    @staticmethod
    def base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def tiny(**kw) -> "BertConfig":
        """Test-sized config (2 layers, 64 wide)."""
        defaults = dict(vocab_size=512, hidden_size=64, num_layers=2,
                        num_heads=4, intermediate_size=128, max_len=64,
                        dtype=torch.float32)
        defaults.update(kw)
        return BertConfig(**defaults)


class Dense(nn.Module):
    """flax ``Dense``/``DenseGeneral``: ``kernel`` [*in_shape, *out_shape]
    contracts the input's trailing ``len(in_shape)`` axes; ``bias``
    [*out_shape]. Input, kernel and bias are cast to ``dtype`` first. The
    kernel may be a rank's slice (its shapes are read off the tensor); as
    a row-parallel layer (``mesh`` given) each rank's partial product,
    in ``dtype`` as one process computes the whole, is all-reduced over
    'model' in ``dtype`` and the bias added after the sum (at two ranks
    the sum of the two partials rounds once, as an f32 sum cast back
    would)."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int],
                 dtype: torch.dtype, generator=None, device=None):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.dtype = dtype
        self.n_in = math.prod(self.in_shape)
        self.kernel = nn.Parameter(torch.empty(self.in_shape + self.out_shape,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(self.out_shape, device=device))
        # lecun_normal with fan-in over the contracted axes
        std = math.sqrt(1.0 / self.n_in) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.kernel, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)

    def forward(self, x, mesh=None):
        n = len(self.in_shape)
        n_in = math.prod(self.kernel.shape[:n])
        lead = x.shape[:x.dim() - n]
        xin = x.reshape(*lead, n_in).to(self.dtype)
        w = self.kernel.reshape(n_in, -1).to(self.dtype)
        y = torch.matmul(xin, w)
        if mesh is not None:
            y = collectives.reduce_from_axis(y, mesh, MODEL_AXIS)
        y = y + self.bias.reshape(-1).to(self.dtype)
        return y.reshape(*lead, *self.kernel.shape[n:])


class LayerNorm(nn.Module):
    """flax ``LayerNorm`` in f32 (eps 1e-12): ``scale`` and ``bias``."""

    def __init__(self, size: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(size, device=device))
        self.bias = nn.Parameter(torch.zeros(size, device=device))

    def forward(self, x):
        return F.layer_norm(x.float(), self.scale.shape, self.scale,
                            self.bias, eps=_LN_EPS)


class _EmbedLookup(torch.autograd.Function):
    """``F.embedding``'s forward with a backward whose summation order is
    fixed: the output gradients are stably sorted by id and each id's rows
    summed in that order (``segment_reduce``). PyTorch's CUDA backward of
    ``F.embedding`` sums a heavily repeated id in an order that changes
    from run to run (all 16,384 token-type ids of a 32 x 512 batch are 0;
    measured on an H100), which made BERT's default path differ from
    itself; the reference's XLA program is deterministic."""

    @staticmethod
    def forward(ctx, ids, table):
        ctx.save_for_backward(ids)
        ctx.num_rows = table.shape[0]
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, gy):
        # on the card autograd's device thread runs this: the span
        # parents to the fused step through the tracer's held context
        with obs.tracer().child("embed_bwd", "step", held=True):
            (ids,) = ctx.saved_tensors
            flat = ids.reshape(-1)
            gy = gy.reshape(flat.numel(), -1)
            order = torch.argsort(flat, stable=True)
            rows, counts = torch.unique_consecutive(flat[order],
                                                    return_counts=True)
            sums = torch.segment_reduce(gy[order], "sum", lengths=counts)
            grad = gy.new_zeros((ctx.num_rows, gy.shape[1]))
            grad[rows] = sums  # distinct rows: a plain write
        return None, grad


class Embed(nn.Module):
    """flax ``Embed``: ``embedding`` [num, features], drawn from a normal
    of variance 1/features (flax's default embedding init). Its backward
    is deterministic (:class:`_EmbedLookup`)."""

    def __init__(self, num: int, features: int, generator=None, device=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty((num, features),
                                                  device=device))
        with torch.no_grad():
            nn.init.normal_(self.embedding, std=math.sqrt(1.0 / features),
                            generator=generator)

    def forward(self, ids):
        return _EmbedLookup.apply(ids, self.embedding)


def _need_mesh(mesh) -> None:
    if mesh is None:
        raise ValueError("the attention and FFN kernels are a rank's "
                         "'model' slices: the forward needs the store's "
                         "mesh (make_mlm_loss_fn(model, mesh=store.mesh))")


class SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.num_heads
        d = cfg.hidden_size // h
        H = cfg.hidden_size
        for name in ("query", "key", "value"):
            setattr(self, name, Dense((H,), (h, d), cfg.dtype, generator,
                                      device))
        self.out = Dense((h, d), (H,), cfg.dtype, generator, device)

    def forward(self, x, mask, mesh=None):
        cfg = self.cfg
        # the rank's heads: all of them unless the kernels are slices
        tp = self.query.kernel.shape[1] != cfg.num_heads
        if tp:
            _need_mesh(mesh)
            x = collectives.copy_to_axis(x, mesh, MODEL_AXIS)
        q, k, v = self.query(x), self.key(x), self.value(x)  # [B, S, h, d]
        if cfg.attn == "flash":
            out = flash_attention(q, k, v, mask=mask)
        else:
            head_dim = q.shape[-1]
            # the reference divides the compute-type scores by a numpy
            # float64, which promotes them to f32 (x64 off)
            scores = (torch.einsum("bqhd,bkhd->bhqk", q, k).float()
                      / math.sqrt(head_dim))
            # mask: [B, S] with 1 = attend; softmax in f32
            bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9)
            probs = torch.softmax(scores + bias, dim=-1).to(cfg.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.out(out, mesh if tp else None)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: BertConfig, generator=None, device=None):
        super().__init__()
        H, inter = cfg.hidden_size, cfg.intermediate_size
        self.dtype = cfg.dtype
        self.inter = inter
        self.attention = SelfAttention(cfg, generator, device)
        self.ln_attention = LayerNorm(H, device)
        self.intermediate = Dense((H,), (inter,), cfg.dtype, generator,
                                  device)
        self.output = Dense((inter,), (H,), cfg.dtype, generator, device)
        self.ln_output = LayerNorm(H, device)

    def forward(self, x, mask, mesh=None):
        # post-LN (original BERT): sublayer -> residual -> LayerNorm
        a = self.attention(x, mask, mesh)
        x = self.ln_attention(x + a).to(self.dtype)
        tp = self.intermediate.kernel.shape[1] != self.inter
        h = collectives.copy_to_axis(x, mesh, MODEL_AXIS) if tp else x
        h = F.gelu(self.intermediate(h), approximate="tanh")
        h = self.output(h, mesh if tp else None)
        return self.ln_output(x + h).to(self.dtype)


class BertMLM(nn.Module):
    """BERT encoder + tied-embedding MLM head.

    ``forward(input_ids, attention_mask, token_type_ids=None, mesh=None)
    -> logits [B, S, V] (float32)``; ``mesh`` is what a tensor-parallel
    forward (slices of the Megatron leaves) reduces over. ``device='meta'``
    builds the shapes alone.
    """

    def __init__(self, cfg: BertConfig,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.token_embed = Embed(cfg.vocab_size, H, generator, device)
        self.position_embed = Embed(cfg.max_len, H, generator, device)
        self.type_embed = Embed(cfg.type_vocab_size, H, generator, device)
        self.ln_embed = LayerNorm(H, device)
        self._layers = []
        for i in range(cfg.num_layers):
            layer = EncoderLayer(cfg, generator, device)
            setattr(self, f"layer_{i}", layer)
            self._layers.append(layer)
        self.mlm_transform = Dense((H,), (H,), cfg.dtype, generator, device)
        self.ln_mlm = LayerNorm(H, device)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size,
                                                 device=device))

    def forward(self, input_ids, attention_mask, token_type_ids=None,
                mesh=None):
        cfg = self.cfg
        seq = input_ids.shape[1]
        if seq > cfg.max_len:
            raise ValueError(
                f"sequence length {seq} exceeds max_len {cfg.max_len}; "
                f"position ids would silently clamp")
        x = self.token_embed(input_ids)
        x = x + self.position_embed.embedding[:seq][None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = x + self.type_embed(token_type_ids)
        x = self.ln_embed(x).to(cfg.dtype)
        for layer in self._layers:
            x = layer(x, attention_mask, mesh)
        # MLM head: transform + tied decoder, in f32
        x = F.gelu(self.mlm_transform(x), approximate="tanh")
        x = self.ln_mlm(x).to(cfg.dtype)
        logits = torch.matmul(x.float(), self.token_embed.embedding.t())
        return logits + self.mlm_bias

    def param_tree(self) -> Dict[str, dict]:
        """The parameters as the reference's nested dict (``{'layer_0':
        {'attention': {'query': {'kernel', 'bias'}}}}``, ...), which a
        KVStore registers under the same keys."""
        tree: dict = {}
        for name, p in self.named_parameters():
            *path, leaf = name.split(".")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = p
        return tree

    @torch.no_grad()
    def params_from_jax(self, flat: Dict[str, np.ndarray]) -> None:
        """Load the reference's parameters, given as ``{key: array}`` in
        ``ps_tpu.kv.keys.flatten_with_keys`` keys. The layouts are the
        reference's, so every array is copied as it is; a key or shape
        that does not fit raises."""
        own = {name.replace(".", "/"): p
               for name, p in self.named_parameters()}
        if set(flat) != set(own):
            raise ValueError(f"keys {sorted(set(flat) ^ set(own))} do not "
                             f"match the module's parameters")
        for key, arr in flat.items():
            src = torch.tensor(np.asarray(arr, np.float32))
            if tuple(src.shape) != tuple(own[key].shape):
                raise ValueError(f"{key}: shape {tuple(src.shape)} does not "
                                 f"fit {tuple(own[key].shape)}")
            own[key].copy_(src)


def mlm_loss(logits, labels, ignore_index: int = -100, mesh=None):
    """Mean cross-entropy over masked positions only (labels ==
    ignore_index elsewhere), in the logsumexp form ``lse(logits) -
    logits[label]``; an all-ignored batch gives 0.

    With the ``mesh`` of k > 1 ranks, ``labels`` are this rank's slice of
    the global batch, and the mean is the global batch's (as the
    reference's loss over the sharded batch takes it): this rank's sum
    over the global count of masked positions, times k, so the mean over
    the ranks, which the step reports and whose gradient the server
    applies, is the global mean (every rank must make the call)."""
    valid = labels != ignore_index
    safe_labels = torch.where(valid, labels, 0).long()
    lse = torch.logsumexp(logits.float(), dim=-1)
    tok = torch.gather(logits, -1, safe_labels[..., None])[..., 0].float()
    ce = lse - tok
    if mesh is None or mesh.group is None or mesh.size == 1:
        return (ce * valid).sum() / torch.clamp(valid.sum(), min=1)
    n = collectives.all_reduce(valid.sum().reshape(1), mesh)[0]
    return (ce * valid).sum() / (torch.clamp(n, min=1) / mesh.size)


def make_mlm_loss_fn(model: BertMLM, mesh=None):
    """PS-step loss closure: ``loss_fn(params, batch) -> loss`` over the
    data generator's {input_ids, labels, attention_mask} dict batches, with
    ``params`` the nested dict of :meth:`BertMLM.param_tree` (or, under
    :func:`bert_partition_rules` on a 'model' axis, the rank's slices of
    the Megatron leaves); with the store's ``mesh`` (``KVStore.mesh``) the
    mean is the global batch's, and a sliced forward reduces over its
    'model' axis."""

    def loss_fn(params, batch):
        flat, _ = keymod.flatten_with_keys(params)
        logits = torch.func.functional_call(
            model, {k.replace("/", "."): p for k, p in flat.items()},
            (batch["input_ids"], batch["attention_mask"]),
            {"mesh": mesh})
        return mlm_loss(logits, batch["labels"], mesh=mesh)

    return loss_fn


def bert_partition_rules():
    """Megatron tensor-parallel placement for :class:`BertMLM` params
    (pass to ``KVStore(partition_rules=...)`` on a mesh with a 'model'
    axis): Q/K/V shard the HEADS dim (column-parallel with their biases),
    the attention out-projection and the FFN output are row-parallel
    (biases replicate — they add after the reduction), the FFN
    intermediate is column-parallel. Embeddings and LayerNorms are left
    to the heuristic, and the store all-gathers them for the forward.
    The reference's rules, verbatim."""
    return [
        (r"attention/(query|key|value)/kernel$", (None, "model", None)),
        (r"attention/(query|key|value)/bias$", ("model", None)),
        (r"attention/out/kernel$", ("model", None, None)),
        (r"attention/out/bias$", (None,)),
        (r"/intermediate/kernel$", (None, "model")),
        (r"/intermediate/bias$", ("model",)),
        (r"/output/kernel$", ("model", None)),
        (r"/output/bias$", (None,)),
    ]
