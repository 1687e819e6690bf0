"""The one traffic generator: a pool of distinct batches made on the card
from the seed, with the parameters of a traffic file.

A traffic file (``portbench/traffic/<name>.json``) names its ``inputs``
kind and their sizes; the configuration gives the vocabulary or the
classes. Both kinds copy the distributions of ``ps_tpu_torch``'s
``data/synthetic.py`` (``mlm_batches``, ``imagenet_batches``), drawn
here with a ``torch.Generator`` on the card in one call a tensor:

- ``mlm``: ``batch`` x ``seq_len`` token ids uniform over
  ``[first_token_id, vocab_size)``, each position masked with probability
  ``mask_rate`` (its id replaced by ``mask_id``, its label the true id;
  every other label -100), every position attended;
- ``images``: ``batch`` NHWC float32 images of ``image_size``² from a
  unit normal, labels uniform over the configuration's classes.

Every batch of a pool has the same shapes, so every seed gives the same
work; the seed changes only the values.
"""

from __future__ import annotations

from typing import List

import torch


def make_pool(cfg: dict, traffic: dict, generator: torch.Generator,
              device) -> List:
    """``traffic["pool"]`` batches: dicts of ``input_ids``, ``labels`` and
    ``attention_mask`` (int32) for ``mlm``, ``(images, labels)`` for
    ``images``."""
    if traffic.get("loop") != "closed":
        raise ValueError("the harness drives a closed loop: traffic 'loop' "
                         "must be 'closed'")
    n, b = traffic["pool"], traffic["batch"]
    kind = traffic["inputs"]
    if kind == "mlm":
        s, vocab = traffic["seq_len"], cfg["vocab_size"]
        ids = torch.randint(traffic["first_token_id"], vocab, (n, b, s),
                            generator=generator, device=device,
                            dtype=torch.int32)
        masked = torch.rand((n, b, s), generator=generator,
                            device=device) < traffic["mask_rate"]
        labels = torch.where(masked, ids, torch.full_like(ids, -100))
        input_ids = torch.where(masked,
                                torch.full_like(ids, traffic["mask_id"]), ids)
        attend = torch.ones_like(ids)
        return [{"input_ids": input_ids[i], "labels": labels[i],
                 "attention_mask": attend[i]} for i in range(n)]
    if kind == "images":
        size = traffic["image_size"]
        images = torch.randn((n, b, size, size, cfg["in_channels"]),
                             generator=generator, device=device)
        labels = torch.randint(0, cfg["num_classes"], (n, b),
                               generator=generator, device=device,
                               dtype=torch.int32)
        return [(images[i], labels[i]) for i in range(n)]
    raise ValueError(f"traffic inputs {kind!r}: the generator makes 'mlm' "
                     f"and 'images'")


def first_half(batch):
    """The first half of every tensor of a batch (a fault that tests of the
    comparison plant: half of the batch left out)."""
    def half(t):
        return t[:t.shape[0] // 2]
    if isinstance(batch, dict):
        return {k: half(v) for k, v in batch.items()}
    return type(batch)(half(v) for v in batch)
