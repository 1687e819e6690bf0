"""Deterministic synthetic batches shaped like the reference's workloads,
numpy only.

Counterpart of ``ps_tpu/data/synthetic.py`` (``mnist_batches``,
``imagenet_batches``, ``mlm_batches`` and ``criteo_batches``, copied as
they are): the same seed gives byte-identical batches in both packages.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def mnist_batches(batch_size: int, *, seed: int = 0, steps: int = None,
                  worker: int = 0, num_workers: int = 1) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yields (images [B,28,28,1] float32 in [0,1], labels [B] int32).

    Sharding contract: each step draws one deterministic *global* batch of
    ``batch_size * num_workers`` examples (a pure function of (seed, step)),
    and worker ``w`` receives rows ``[w*B, (w+1)*B)``. Concatenating all
    workers' batches therefore reproduces exactly the single-worker
    ``batch_size * num_workers`` stream — the property the data-parallel
    parity tests rely on.

    The images are class-conditional sinusoidal gratings (class-dependent
    frequency/orientation) plus noise, so both a linear model (per-pixel
    pattern) and a convnet with global pooling (local texture statistics)
    can learn.
    """
    if not (0 <= worker < num_workers):
        raise ValueError(f"worker {worker} out of range [0, {num_workers})")
    # one fixed grating prototype per class
    proto_rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:28, 0:28]
    freqs = proto_rng.uniform(1.5, 6.0, size=(10, 2))
    phases = proto_rng.uniform(0, 2 * np.pi, size=10)
    protos = 0.5 + 0.35 * np.sin(
        2 * np.pi * (freqs[:, :1, None] * xx + freqs[:, 1:, None] * yy) / 28
        + phases[:, None, None]
    )
    protos = protos[..., None].astype(np.float32)
    gb = batch_size * num_workers
    i = 0
    while steps is None or i < steps:
        rng = np.random.default_rng([seed, i])
        labels = rng.integers(0, 10, size=gb).astype(np.int32)
        noise = 0.3 * rng.standard_normal(size=(gb, 28, 28, 1), dtype=np.float32)
        images = np.clip(protos[labels] + noise, 0.0, 1.0)
        sl = slice(worker * batch_size, (worker + 1) * batch_size)
        yield images[sl], labels[sl]
        i += 1


def imagenet_batches(batch_size: int, *, image_size: int = 224, seed: int = 0,
                     steps: int = None) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yields (images [B,H,W,3] float32, labels [B] int32 in [0,1000))."""
    rng = np.random.default_rng(seed)
    i = 0
    while steps is None or i < steps:
        # float32 end to end: ~1.5x faster than normal()+cast and half the
        # host memory traffic
        images = rng.standard_normal(
            size=(batch_size, image_size, image_size, 3), dtype=np.float32
        )
        labels = rng.integers(0, 1000, size=batch_size).astype(np.int32)
        yield images, labels
        i += 1


def mlm_batches(batch_size: int, seq_len: int, *, vocab_size: int = 30522,
                mask_rate: float = 0.15, mask_id: int = 103, seed: int = 0,
                steps: int = None) -> Iterator[dict]:
    """Yields BERT-MLM dicts: input_ids, labels (-100 = unmasked), attention_mask."""
    rng = np.random.default_rng(seed)
    # reserve a low-id band for special tokens (BERT-style); shrink it for
    # tiny test vocabularies
    low = max(min(1000, vocab_size // 4), mask_id + 1)
    if low >= vocab_size:
        raise ValueError(f"vocab_size {vocab_size} too small (mask_id {mask_id})")
    i = 0
    while steps is None or i < steps:
        ids = rng.integers(low, vocab_size, size=(batch_size, seq_len)).astype(np.int32)
        mask = rng.random((batch_size, seq_len)) < mask_rate
        labels = np.where(mask, ids, -100).astype(np.int32)
        input_ids = np.where(mask, mask_id, ids).astype(np.int32)
        yield {
            "input_ids": input_ids,
            "labels": labels,
            "attention_mask": np.ones_like(input_ids),
        }
        i += 1


def criteo_batches(batch_size: int, *, num_dense: int = 13, num_sparse: int = 26,
                   vocab_size: int = 100_000, seed: int = 0,
                   steps: int = None) -> Iterator[dict]:
    """Yields Criteo-like dicts: dense [B,13] float32, sparse ids [B,26] int32,
    label [B] float32 (CTR 0/1). Sparse ids follow a Zipf-ish skew like real
    Criteo so duplicate-row handling in the sparse path is actually exercised.
    """
    rng = np.random.default_rng(seed)
    i = 0
    while steps is None or i < steps:
        dense = rng.normal(0.0, 1.0, size=(batch_size, num_dense)).astype(np.float32)
        # Zipf-like skew, clipped into vocab
        raw = rng.zipf(1.2, size=(batch_size, num_sparse))
        sparse = ((raw - 1) % vocab_size).astype(np.int32)
        logits = 0.5 * dense[:, 0] + 0.1 * (sparse[:, 0] % 7 - 3)
        label = (logits + rng.normal(0, 1, size=batch_size) > 0).astype(np.float32)
        yield {"dense": dense, "sparse": sparse, "label": label}
        i += 1
