"""Minimal causal transformer LM — the long-context workload.

Counterpart of ``ps_tpu/models/lm.py``: pure functions over a param dict
(the tree a KVStore shards by key), pre-norm blocks (RMSNorm), learned
positions, a weight-tied readout, and a pluggable attention op
(:func:`make_attn_fn`): ``'full'``, ``'flash'`` (the port's flash kernel,
causal), or ``'ring'``/``'ulysses'``
(:mod:`ps_tpu_torch.parallel.ring_attention`) when the activations are
split along a 'seq' mesh axis. The initial weights are the reference's
numpy draws, so the same seed gives the same tree.

The parallel forms are explicit where the reference's GSPMD inserts the
collectives:

- 'seq': each rank holds its block of every sequence; :func:`embed_apply`
  takes the positions of its block's offset and :func:`token_ce` gives
  its part of the mean over the global tokens (the parts sum to it; the
  store sums the gradients over 'seq');
- 'model' under :func:`lm_partition_rules`: the rank holds its column
  slice of ``qkv`` and ``mlp/in`` and its row slice of ``attn/out`` and
  ``mlp/out``. The qkv columns ``[q | k | v]`` do not fall on head
  boundaries, so the rank's qkv activations are all-gathered over
  'model' and every rank attends over all heads; ``attn/out`` takes the
  rank's slice of the attention output, ``mlp`` is column- then
  row-parallel, and the row-parallel partial sums are all-reduced
  (Megatron's ``f`` and ``g``);
- 'pipe': :func:`make_pipelined_loss_fn` runs the stacked blocks as a
  GPipe trunk (:mod:`ps_tpu_torch.parallel.pipeline`) between the embed
  and the readout, which stay ordinary tensors.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ps_tpu_torch.kv import keys as keymod
from ps_tpu_torch.parallel import collectives
from ps_tpu_torch.parallel.mesh import MODEL_AXIS, SEQ_AXIS


def init_params(rng: np.random.Generator, *, vocab: int, d_model: int,
                n_heads: int, n_layers: int, d_ff: Optional[int] = None,
                max_len: int = 2048) -> Dict:
    """The reference's scaled-normal init, drawn from ``rng`` in its
    order, as f32 tensors."""
    d_ff = d_ff or 4 * d_model

    def t(*shape, scale=None):
        scale = scale if scale is not None else (1.0 / math.sqrt(shape[0]))
        return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32))

    params: Dict = {
        "embed": {"tokens": t(vocab, d_model, scale=0.02),
                  "positions": t(max_len, d_model, scale=0.02)},
        "final_norm": {"scale": torch.ones((d_model,))},
    }
    for i in range(n_layers):
        params[f"layer{i}"] = {
            "ln1": {"scale": torch.ones((d_model,))},
            "attn": {
                "qkv": {"kernel": t(d_model, 3 * d_model)},
                "out": {"kernel": t(d_model, d_model)},
            },
            "ln2": {"scale": torch.ones((d_model,))},
            "mlp": {
                "in": {"kernel": t(d_model, d_ff)},
                "out": {"kernel": t(d_ff, d_model)},
            },
        }
    return params


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict:
    """The reference's tree, given as ``{key: array}`` in
    ``ps_tpu.kv.keys.flatten_with_keys`` keys, as the nested dict of f32
    tensors this module takes."""
    tree: Dict = {}
    for key, arr in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = torch.tensor(np.asarray(arr, np.float32))
    return tree


def lm_partition_rules():
    """Megatron placement for every layer (regexes match all layer
    indices): in-projections column-parallel, out-projections
    row-parallel; embeddings left to the heuristic. The four kernels of a
    block go together (:func:`block_apply` reads the placement off the
    qkv kernel)."""
    return [
        (r"attn/qkv/kernel$", (None, "model")),
        (r"attn/out/kernel$", ("model", None)),
        (r"mlp/in/kernel$", (None, "model")),
        (r"mlp/out/kernel$", ("model", None)),
    ]


def _rmsnorm(x, scale):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + 1e-6) * scale


def _full_attention(q, k, v, causal=True, **_):
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (q.shape[-1] ** -0.5)
    if causal:
        t = q.shape[1]
        keep = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(keep[None, None], s, torch.full_like(s, -1e30))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


_full_attention.attn = "full"


SEQ_ATTNS = ("ring", "ulysses")


def _seq_size(mesh) -> int:
    return mesh.axis_size(SEQ_AXIS) if mesh is not None else 1


def check_attn(attn: str, seq: int) -> None:
    """Refuse an attention that cannot span a 'seq' axis of ``seq`` ranks:
    'full' and 'flash' attend within the block of the sequence they are
    given, so on a rank's block they would train another model."""
    if seq > 1 and attn not in SEQ_ATTNS:
        raise ValueError(f"attn {attn!r} attends within a rank's block; a "
                         f"seq axis > 1 ({seq}) needs ring or ulysses")


def _check_attn_fn(attn_fn: Callable, mesh) -> None:
    """:func:`check_attn` for an attention function: one that
    :func:`make_attn_fn` made for 'ring'/'ulysses' spans the axis."""
    check_attn(getattr(attn_fn, "attn", getattr(attn_fn, "__name__", "?")),
               _seq_size(mesh))


def make_attn_fn(attn: str = "full", mesh=None, **kw) -> Callable:
    """'full' | 'flash' | 'ring' | 'ulysses'. 'flash' is
    :func:`ps_tpu_torch.ops.flash_attention`, the CUDA kernel on the card
    (seq a multiple of 128; the head widths the kernel is built for,
    others refused on any device); 'ring'/'ulysses' need the ``mesh``'s
    'seq' axis and this rank's blocks of the sequence, and are the only
    ones a 'seq' axis larger than 1 takes. The function carries its name
    as ``attn``."""
    if attn not in ("full", "flash") + SEQ_ATTNS:
        raise ValueError(f"unknown attn {attn!r}; want full, flash, ring or "
                         f"ulysses")
    check_attn(attn, _seq_size(mesh))
    if attn == "full":
        return _full_attention
    if attn == "flash":
        from ps_tpu_torch.ops.flash_attention import HEAD_DIMS, flash_attention

        def flash_fn(q, k, v, causal=True):
            if q.shape[-1] not in HEAD_DIMS:
                raise ValueError(
                    f"attn='flash': the kernel is built for head widths "
                    f"{HEAD_DIMS}, this model's is {q.shape[-1]} "
                    f"(d_model / n_heads)")
            return flash_attention(q, k, v, causal=causal, **kw)

        flash_fn.attn = attn
        return flash_fn
    from ps_tpu_torch.parallel.ring_attention import (ring_attention,
                                                      ulysses_attention)

    op = {"ring": ring_attention, "ulysses": ulysses_attention}[attn]

    def fn(q, k, v, causal=True):
        return op(q, k, v, mesh, causal=causal, **kw)

    fn.attn = attn
    return fn


def block_apply(lp: Dict, x: torch.Tensor, *, n_heads: int,
                attn_fn: Callable = _full_attention,
                mesh=None) -> torch.Tensor:
    """One pre-norm transformer block: activations [B, T, D] -> [B, T, D].
    The homogeneous unit the pipeline trunk repeats. Kernels sliced over
    'model' (:func:`lm_partition_rules`) run the Megatron form over the
    ``mesh``."""
    b, t, d_model = x.shape
    dh = d_model // n_heads
    qkv_k = lp["attn"]["qkv"]["kernel"]
    tp = qkv_k.shape[1] != 3 * d_model
    if tp and mesh is None:
        raise ValueError("the block's kernels are a rank's 'model' slices: "
                         "block_apply needs the mesh (make_loss_fn(..., "
                         "mesh=store.mesh))")
    h = _rmsnorm(x, lp["ln1"]["scale"])
    if tp:
        h = collectives.copy_to_axis(h, mesh, MODEL_AXIS)
        qkv = collectives.gather_from_axis(h @ qkv_k, mesh, MODEL_AXIS, 2)
    else:
        qkv = h @ qkv_k
    q, k, v = torch.split(qkv.reshape(b, t, 3 * n_heads, dh), n_heads, dim=2)
    a = attn_fn(q, k, v, causal=True).reshape(b, t, d_model)
    if tp:
        a = collectives.split_to_axis(a, mesh, MODEL_AXIS, 2)
        x = x + collectives.reduce_from_axis(
            a @ lp["attn"]["out"]["kernel"], mesh, MODEL_AXIS)
        h = collectives.copy_to_axis(_rmsnorm(x, lp["ln2"]["scale"]), mesh,
                                     MODEL_AXIS)
        h = F.gelu(h @ lp["mlp"]["in"]["kernel"], approximate="tanh")
        return x + collectives.reduce_from_axis(
            h @ lp["mlp"]["out"]["kernel"], mesh, MODEL_AXIS)
    x = x + a @ lp["attn"]["out"]["kernel"]
    h = _rmsnorm(x, lp["ln2"]["scale"])
    h = F.gelu(h @ lp["mlp"]["in"]["kernel"], approximate="tanh")
    return x + h @ lp["mlp"]["out"]["kernel"]


def _seq_offset(t: int, mesh) -> int:
    """This rank's first position: its 'seq' index times its block."""
    return mesh.axis_index(SEQ_AXIS) * t if mesh is not None else 0


def embed_apply(params: Dict, tokens: torch.Tensor,
                offset: int = 0) -> torch.Tensor:
    """The heterogeneous FIRST stage: tokens [B, T] -> activations
    [B, T, D], the positions from ``offset`` (a 'seq' rank's block)."""
    t = tokens.shape[-1]
    return (F.embedding(tokens.long(), params["embed"]["tokens"])
            + params["embed"]["positions"][offset:offset + t][None])


def readout_apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """The heterogeneous LAST stage: final norm + weight-tied readout,
    activations [B, T, D] -> logits [B, T, vocab]."""
    x = _rmsnorm(x, params["final_norm"]["scale"])
    return x @ params["embed"]["tokens"].t()


def apply(params: Dict, tokens: torch.Tensor, *, n_heads: int,
          attn_fn: Callable = _full_attention, mesh=None) -> torch.Tensor:
    """tokens [B, T] int -> logits [B, T, vocab] (this rank's block of the
    sequence on a 'seq' axis, where ``attn_fn`` must be ring or
    ulysses)."""
    _check_attn_fn(attn_fn, mesh)
    x = embed_apply(params, tokens, _seq_offset(tokens.shape[-1], mesh))
    i = 0
    while f"layer{i}" in params:
        x = block_apply(params[f"layer{i}"], x, n_heads=n_heads,
                        attn_fn=attn_fn, mesh=mesh)
        i += 1
    return readout_apply(params, x)


def token_ce(logits, targets, mesh=None):
    """Mean next-token CE in logsumexp form. On a 'seq' axis of s ranks
    this rank's part of its sequences' mean: its tokens' sum over s times
    its token count (the parts sum to the mean over the global tokens)."""
    lse = torch.logsumexp(logits.float(), -1)
    tok = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    ce = lse - tok.float()
    sp = mesh.axis_size(SEQ_AXIS) if mesh is not None else 1
    if sp == 1:
        return torch.mean(ce)
    return ce.sum() / (ce.numel() * sp)


def make_loss_fn(*, n_heads: int, attn_fn: Callable = _full_attention,
                 mesh=None):
    """Next-token cross entropy over pre-shifted ``inputs``/``targets``
    [B, T] (this rank's part of the global batch, :func:`lm_batches`):
    the global batch's mean once the store has reduced it. On a 'seq'
    axis larger than 1 ``attn_fn`` must be ring or ulysses."""
    _check_attn_fn(attn_fn, mesh)

    def loss_fn(params, batch):
        logits = apply(params, batch["inputs"], n_heads=n_heads,
                       attn_fn=attn_fn, mesh=mesh)
        return token_ce(logits, batch["targets"], mesh)

    return loss_fn


def split_pipeline_params(params: Dict, num_stages: int) -> Dict:
    """Rearrange an :func:`init_params` tree for dp x pp training: the
    embed and readout params stay ordinary tensors under their own keys,
    and the ``n_layers`` homogeneous blocks are stacked ``[S, k, ...]``
    under ``"stages"`` (S pipeline stages of k layers each) for
    ``('pipe', ...)`` placement (the reference's layout)."""
    n_layers = 0
    while f"layer{n_layers}" in params:
        n_layers += 1
    if n_layers == 0 or n_layers % num_stages:
        raise ValueError(
            f"{n_layers} layers do not split into {num_stages} equal stages")
    k = n_layers // num_stages
    flat = [keymod.flatten_with_keys(params[f"layer{i}"])[0]
            for i in range(n_layers)]
    _, treedef = keymod.flatten_with_keys(params["layer0"])
    keys = list(flat[0])
    stacked = {key: torch.stack([
        torch.stack([flat[s * k + j][key] for j in range(k)])
        for s in range(num_stages)]) for key in keys}
    return {"embed": params["embed"], "final_norm": params["final_norm"],
            "stages": keymod.unflatten(treedef, stacked, keys)}


def pipeline_lm_partition_rules(extra=()):
    """Partition rules for a :func:`split_pipeline_params` tree: every
    ``stages/`` leaf's leading dim on 'pipe'; embed/readout left to the
    heuristic or to ``extra`` rules."""
    from ps_tpu_torch.parallel.pipeline import pipeline_partition_rules

    return pipeline_partition_rules(max_rank=5, pattern=r"^stages/") \
        + list(extra)


def make_pipelined_loss_fn(*, n_heads: int, num_stages: int,
                           microbatches: int, mesh=None,
                           attn_fn: Callable = _full_attention):
    """Next-token CE through the dp x pp pipeline: embed (once a
    microbatch's worth, on every pipe rank) -> GPipe trunk over 'pipe' ->
    final norm + tied readout. ``params`` are a
    :func:`split_pipeline_params` tree placed by
    :func:`pipeline_lm_partition_rules` (each pipe rank's ``stages`` its
    own stage), or whole in one process, where the stages run in turn."""
    from ps_tpu_torch.parallel.mesh import PIPE_AXIS
    from ps_tpu_torch.parallel.pipeline import make_pipeline_fn, microbatch

    pp = mesh.axis_size(PIPE_AXIS) if mesh is not None else 1
    if _seq_size(mesh) > 1:
        raise ValueError("the pipelined trunk runs whole sequences: a seq "
                         "axis > 1 does not compose with a pipe axis")
    if pp > 1 and pp != num_stages:
        raise ValueError(f"{num_stages} stages on a 'pipe' axis of {pp}: "
                         f"a pipe rank runs one stage")

    def stage_fn(stage_params, x):
        # the stage's leaves are [k, ...]: k layers, unrolled
        flat, treedef = keymod.flatten_with_keys(stage_params)
        keys = list(flat)
        for j in range(next(iter(flat.values())).shape[0]):
            lp = keymod.unflatten(treedef, {key: flat[key][j] for key in keys},
                                  keys)
            x = block_apply(lp, x, n_heads=n_heads, attn_fn=attn_fn)
        return x

    pipe_fn = make_pipeline_fn(stage_fn, mesh, microbatches=microbatches)

    def loss_fn(params, batch):
        x = embed_apply(params, batch["inputs"])      # [B, T, D]
        h = pipe_fn(params["stages"], microbatch(x, microbatches))
        h = h.reshape((-1,) + tuple(h.shape[2:]))     # [B, T, D]
        return token_ce(readout_apply(params, h), batch["targets"])

    return loss_fn


def lm_batches(batch_size: int, seq_len: int, *, vocab: int = 256,
               seed: int = 0, steps: Optional[int] = None):
    """Deterministic synthetic token streams with LEARNABLE structure
    (the reference's draws): next token = (3·start + 7·position) mod
    vocab, plus noise tokens. Yields pre-shifted numpy ``{"inputs": [B,
    T], "targets": [B, T]}`` int32."""
    rng = np.random.default_rng(seed)
    i = 0
    while steps is None or i < steps:
        start = rng.integers(0, vocab, size=(batch_size, 1))
        ramp = np.arange(seq_len + 1)[None, :]
        toks = (start * 3 + ramp * 7) % vocab
        noise = rng.random((batch_size, seq_len + 1)) < 0.05
        toks = np.where(noise, rng.integers(0, vocab, toks.shape), toks)
        toks = toks.astype(np.int32)
        yield {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
        i += 1
