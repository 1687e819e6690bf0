"""Deterministic synthetic Criteo-like batches, numpy only.

Counterpart of ``ps_tpu/data/synthetic.py`` (``criteo_batches``, copied
as it is): the same seed gives byte-identical batches in both packages.
The other generators are not ported yet.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


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
