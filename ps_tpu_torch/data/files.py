"""File-backed input path: a dataset is a directory of column ``.npy``
files, numpy only.

Counterpart of ``ps_tpu/data/files.py`` (``write_dataset``,
``dataset_fields`` and ``file_batches``, copied as they are): the same
directory, seed and arguments give byte-identical batches in both
packages. One array per field, equal leading dimension, read back
memory-mapped: a batch is a row slice (or a sorted row gather) of the mmap,
so the host never loads the dataset into RAM and a batch costs O(batch
bytes).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Sequence

import numpy as np


def write_dataset(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Materialize ``{field: array}`` as a column-npy dataset directory.

    All arrays must share the leading (example) dimension. Fields become
    ``<path>/<field>.npy``; nested field names may not contain '/'.
    """
    if not arrays:
        raise ValueError("no arrays to write")
    sizes = {name: a.shape[0] for name, a in arrays.items()}
    if len(set(sizes.values())) != 1:
        raise ValueError(f"fields disagree on example count: {sizes}")
    for name in arrays:
        if "/" in name or name.startswith("."):
            raise ValueError(f"bad field name {name!r}")
    os.makedirs(path, exist_ok=True)
    for name, a in arrays.items():
        np.save(os.path.join(path, f"{name}.npy"), np.asarray(a))


def dataset_fields(path: str) -> Dict[str, np.ndarray]:
    """Open every field of a dataset directory memory-mapped (read-only)."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"dataset directory {path!r} does not exist")
    fields = {}
    for fn in sorted(os.listdir(path)):
        if fn.endswith(".npy"):
            fields[fn[:-4]] = np.load(os.path.join(path, fn), mmap_mode="r")
    if not fields:
        raise ValueError(f"no .npy fields under {path!r}")
    n = {name: a.shape[0] for name, a in fields.items()}
    if len(set(n.values())) != 1:
        raise ValueError(f"corrupt dataset: fields disagree on rows: {n}")
    return fields


def file_batches(path: str, batch_size: int, *,
                 fields: Optional[Sequence[str]] = None,
                 steps: Optional[int] = None,
                 shuffle: bool = False, seed: int = 0,
                 worker: int = 0, num_workers: int = 1,
                 as_tuple: Optional[Sequence[str]] = None
                 ) -> Iterator:
    """Stream batches from a column-npy dataset directory.

    Args:
      path: directory produced by :func:`write_dataset`.
      batch_size: PER-WORKER batch size; each step consumes a global batch
        of ``batch_size * num_workers`` rows and worker ``w`` receives rows
        ``[w*B, (w+1)*B)`` of it.
      fields: subset of field names to read (default: all, sorted).
      steps: stop after this many batches (default: loop over the file
        forever, rewinding at the end).
      shuffle: reshuffle the row order every epoch (deterministic in
        ``seed``; all workers derive the same permutation). Rows within a
        batch are gathered in ascending file order (forward seeks only).
      as_tuple: emit ``tuple(batch[k] for k in as_tuple)`` instead of a
        dict — adapts image datasets to the (images, labels) interface.

    Batches whose global window would run past the file are dropped (the
    remainder rolls into the next epoch's view), so every batch is full.
    """
    if not (0 <= worker < num_workers):
        raise ValueError(f"worker {worker} out of range [0, {num_workers})")
    cols = dataset_fields(path)
    if fields is not None:
        missing = [f for f in fields if f not in cols]
        if missing:
            raise KeyError(f"dataset {path!r} has no fields {missing}; "
                           f"found {sorted(cols)}")
        cols = {f: cols[f] for f in fields}
    if as_tuple is not None:
        missing = [f for f in as_tuple if f not in cols]
        if missing:
            raise KeyError(f"as_tuple names absent fields {missing}")
    n = next(iter(cols.values())).shape[0]
    gb = batch_size * num_workers
    if gb > n:
        raise ValueError(
            f"global batch {gb} exceeds dataset rows {n} ({path!r})"
        )
    per_epoch = n // gb
    i = 0
    order = None
    while steps is None or i < steps:
        j = i % per_epoch
        if j == 0:
            epoch = i // per_epoch
            order = (np.random.default_rng([seed, epoch]).permutation(n)
                     if shuffle else None)
        lo = j * gb + worker * batch_size
        hi = lo + batch_size
        if order is None:
            # contiguous mmap slice: one read of exactly the batch rows
            batch = {k: np.asarray(a[lo:hi]) for k, a in cols.items()}
        else:
            idx = np.sort(order[lo:hi])  # sorted gather = forward seeks only
            batch = {k: np.asarray(a[idx]) for k, a in cols.items()}
        if as_tuple is not None:
            yield tuple(batch[k] for k in as_tuple)
        else:
            yield batch
        i += 1
