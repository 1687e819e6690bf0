"""The plain reference of ``bert_base``: BERT's masked-LM pre-training step,
as Devlin et al. 2019 and google-research/bert's ``modeling.py`` define
it, in float32 plain PyTorch.

A post-LN encoder (LayerNorm eps 1e-12, GELU in its tanh form, as
``modeling.py``'s ``gelu``), the MLM head (dense, GELU, LayerNorm, the
decoder tied to the token embedding, plus a bias), and the mean
cross-entropy over the masked positions. Departures from the paper, all
the configuration's: no dropout (its probabilities are listed as reduced
to 0), no next-sentence head, and the decoder run at every position
rather than at the masked ones only (the loss still counts only those).

Parameters use one tensor per key in the layout of the flax BERT that
the system follows (query, key and value kernels ``[H, heads, head
width]``, the output kernel ``[heads, head width, H]``, dense kernels
``[in, out]``, embeddings ``[rows, H]``). :func:`init_params` draws them
as ``modeling.py`` does: a normal of standard deviation
``initializer_range`` truncated at two deviations for every kernel and
embedding, zeros for biases, ones and zeros for LayerNorm.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import common

_LN_EPS = 1e-12


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every parameter's key and shape, in sorted key order."""
    H, h = cfg["hidden_size"], cfg["num_attention_heads"]
    d, inter = H // h, cfg["intermediate_size"]
    shapes = {
        "token_embed/embedding": (cfg["vocab_size"], H),
        "position_embed/embedding": (cfg["max_position_embeddings"], H),
        "type_embed/embedding": (cfg["type_vocab_size"], H),
        "ln_embed/scale": (H,), "ln_embed/bias": (H,),
        "mlm_transform/kernel": (H, H), "mlm_transform/bias": (H,),
        "ln_mlm/scale": (H,), "ln_mlm/bias": (H,),
        "mlm_bias": (cfg["vocab_size"],),
    }
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layer_{i}/"
        for name in ("query", "key", "value"):
            shapes[f"{pre}attention/{name}/kernel"] = (H, h, d)
            shapes[f"{pre}attention/{name}/bias"] = (h, d)
        shapes[f"{pre}attention/out/kernel"] = (h, d, H)
        shapes[f"{pre}attention/out/bias"] = (H,)
        shapes[f"{pre}intermediate/kernel"] = (H, inter)
        shapes[f"{pre}intermediate/bias"] = (inter,)
        shapes[f"{pre}output/kernel"] = (inter, H)
        shapes[f"{pre}output/bias"] = (H,)
        for ln in ("ln_attention", "ln_output"):
            shapes[f"{pre}{ln}/scale"] = (H,)
            shapes[f"{pre}{ln}/bias"] = (H,)
    return dict(sorted(shapes.items()))


def init_params(cfg: dict, generator: torch.Generator, device
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``(params, state)`` drawn from ``generator`` on ``device``, in
    float32, in one draw for every kernel and embedding. BERT keeps no
    state besides its parameters."""
    shapes = param_shapes(cfg)
    drawn = {k: s for k, s in shapes.items()
             if k.endswith("/kernel") or k.endswith("/embedding")}
    total = sum(math.prod(s) for s in drawn.values())
    flat = common.truncated_normal(total, generator, device)
    flat.mul_(cfg["initializer_range"])
    params = common.split_flat(flat, drawn)
    for k, s in shapes.items():
        if k not in params:
            fill = 1.0 if k.endswith("/scale") else 0.0
            params[k] = torch.full(s, fill, device=device)
    return {k: params[k] for k in shapes}, {}


def _ln(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}/scale"],
                        p[f"{name}/bias"], eps=_LN_EPS)


def _dense(prec, x, p, name, n_in):
    """``x`` [..., n_in] times ``name``'s kernel (reshaped to [n_in, -1]),
    plus its bias (flattened)."""
    w = p[f"{name}/kernel"].reshape(n_in, -1)
    lead = x.shape[:-1]
    y = prec.matmul(x.reshape(-1, n_in), w) + p[f"{name}/bias"].reshape(-1)
    return y.reshape(*lead, -1)


def logits(cfg: dict, p: Dict[str, torch.Tensor], batch: dict,
           prec: common.Precision) -> torch.Tensor:
    """The MLM logits ``[B, S, V]`` in float32."""
    ids = batch["input_ids"].long()
    mask = batch["attention_mask"] > 0
    B, S = ids.shape
    H, h = cfg["hidden_size"], cfg["num_attention_heads"]
    d = H // h
    x = (p["token_embed/embedding"][ids]
         + p["position_embed/embedding"][:S][None]
         + p["type_embed/embedding"][torch.zeros_like(ids)])
    x = _ln(x, p, "ln_embed")
    keep = mask[:, None, None, :]  # [B, 1, 1, S]: keys that may be attended
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layer_{i}/"

        def heads(name):  # [B, S, H] -> [B*h, S, d]
            t = _dense(prec, x, p, f"{pre}attention/{name}", H)
            return t.reshape(B, S, h, d).transpose(1, 2).reshape(B * h, S, d)

        q, k, v = heads("query"), heads("key"), heads("value")
        scores = prec.matmul(q, k.transpose(1, 2)) / math.sqrt(d)
        scores = scores.view(B, h, S, S).masked_fill(~keep, -math.inf)
        # a row with no key to attend gives zeros, not NaN
        probs = torch.nan_to_num(torch.softmax(scores, dim=-1), nan=0.0)
        ctx = prec.matmul(probs.view(B * h, S, S), v)
        ctx = ctx.view(B, h, S, d).transpose(1, 2).reshape(B, S, H)
        a = _dense(prec, ctx, p, f"{pre}attention/out", H)
        x = _ln(x + a, p, f"{pre}ln_attention")
        f = F.gelu(_dense(prec, x, p, f"{pre}intermediate", H),
                   approximate="tanh")
        f = _dense(prec, f, p, f"{pre}output", cfg["intermediate_size"])
        x = _ln(x + f, p, f"{pre}ln_output")
    t = F.gelu(_dense(prec, x, p, "mlm_transform", H), approximate="tanh")
    t = _ln(t, p, "ln_mlm")
    out = prec.matmul(t.reshape(-1, H), p["token_embed/embedding"].t())
    return (out + p["mlm_bias"]).view(B, S, -1)


def loss_fn(cfg: dict):
    """``loss(params, state, batch, precision) -> (loss, state)``: the mean
    cross-entropy over the positions whose label is not -100."""

    def loss(p, state, batch, prec):
        z = logits(cfg, p, batch, prec)
        labels = batch["labels"].long()
        return F.cross_entropy(z.view(-1, z.shape[-1]), labels.view(-1),
                               ignore_index=-100), state

    return loss


def readings(cfg: dict, params, state, batches, precision: str = "float32"
             ) -> dict:
    """The readings of plain training from ``params`` over ``batches`` (one
    step a batch) with the configuration's optimizer: see
    :func:`common.train_readings`."""
    return common.train_readings(loss_fn(cfg), params, state, batches,
                                 cfg["optimizer"],
                                 common.Precision(precision))
