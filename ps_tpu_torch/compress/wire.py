"""Codec frames <-> one contiguous uint8 buffer: the transport adapter.

Counterpart of ``ps_tpu/compress/wire.py``. :func:`pack_frames` writes a
codec's frame dict as one uint8 array (magic, a json header naming the
codec and each frame's dtype and shape, the raw buffers), so an encoded
tensor buckets and reassembles like any tensor; the packed keys travel in
the frame header (``extra["enc"]``) and :func:`decode_tree` reverses them
on the receiver. :class:`GradCompressor` runs on the worker: policy,
packing and the codec accounting.
"""

from __future__ import annotations

import json
import struct
import time
from typing import Dict, List, Tuple

import numpy as np

from ps_tpu_torch.compress.codecs import make_codec
from ps_tpu_torch.compress.policy import CompressPolicy

_MAGIC = b"PSC1"
_HDR = struct.Struct("<4sI")  # magic, meta_len


def pack_frames(codec: str, frames: Dict[str, np.ndarray]) -> np.ndarray:
    """One codec's frame dict as a single uint8 array."""
    names = sorted(frames)
    # reshape keeps 0-d shapes that ascontiguousarray would promote
    arrays = [np.ascontiguousarray(np.asarray(frames[n])).reshape(
        np.asarray(frames[n]).shape) for n in names]
    meta = {
        "codec": codec,
        "frames": [{"name": n, "dtype": a.dtype.str, "shape": list(a.shape)}
                   for n, a in zip(names, arrays)],
    }
    mj = json.dumps(meta).encode()
    buf = np.empty(_HDR.size + len(mj) + sum(a.nbytes for a in arrays),
                   np.uint8)
    _HDR.pack_into(buf, 0, _MAGIC, len(mj))
    off = _HDR.size
    buf[off:off + len(mj)] = np.frombuffer(mj, np.uint8)
    off += len(mj)
    for a in arrays:
        n = a.nbytes
        buf[off:off + n] = a.reshape(-1).view(np.uint8)
        off += n
    return buf


def unpack_frames(buf) -> Tuple[str, Dict[str, np.ndarray]]:
    """Inverse of :func:`pack_frames`; the frames are views of ``buf``."""
    buf = np.asarray(buf).reshape(-1).view(np.uint8)
    magic, mlen = _HDR.unpack_from(buf, 0)
    if magic != _MAGIC:
        raise ValueError("not a packed codec buffer (bad magic)")
    off = _HDR.size
    meta = json.loads(bytes(buf[off:off + mlen]))
    off += mlen
    frames: Dict[str, np.ndarray] = {}
    for f in meta["frames"]:
        dt = np.dtype(f["dtype"])
        n = int(np.prod(f["shape"], dtype=np.int64)) * dt.itemsize
        frames[f["name"]] = buf[off:off + n].view(dt).reshape(f["shape"])
        off += n
    return meta["codec"], frames


# stateless decoders by wire name: frames are self-describing
_DECODERS: Dict[str, object] = {}


def decode_packed(buf) -> np.ndarray:
    """A packed uint8 buffer -> the tensor."""
    name, frames = unpack_frames(buf)
    codec = _DECODERS.get(name)
    if codec is None:
        codec = _DECODERS[name] = make_codec(name)
    return codec.decode(frames)


def decode_tree(arrays: Dict[str, np.ndarray], enc_keys,
                stats=None) -> Dict[str, np.ndarray]:
    """Decode the ``enc_keys`` entries of a received ``{key: array}``
    tree in place (other keys pass untouched); ``enc_keys`` is the frame
    header's ``extra["enc"]``."""
    if not enc_keys:
        return arrays
    t0 = time.perf_counter()
    enc_bytes = 0
    raw_bytes = 0
    for k in enc_keys:
        if k not in arrays:
            raise KeyError(f"enc key {k!r} absent from the received tree")
        enc_bytes += arrays[k].nbytes
        arrays[k] = decode_packed(arrays[k])
        raw_bytes += arrays[k].nbytes
    if stats is not None:
        stats.record_codec(raw_bytes, enc_bytes, time.perf_counter() - t0)
    return arrays


class GradCompressor:
    """The worker's tree encoder: the policy key by key, packing, and the
    raw/encoded bytes, codec seconds and residual norm into ``stats`` (a
    :class:`~ps_tpu_torch.utils.metrics.TransportStats`)."""

    def __init__(self, policy: CompressPolicy, stats=None):
        self.policy = policy
        self.stats = stats

    def encode_tree(self, arrays: Dict[str, np.ndarray]
                    ) -> Tuple[Dict[str, np.ndarray], List[str]]:
        """``{key: array}`` -> (the wire tree, the keys that were packed)."""
        if not self.policy.enabled:
            return arrays, []
        t0 = time.perf_counter()
        out: Dict[str, np.ndarray] = {}
        enc: List[str] = []
        raw_bytes = 0
        enc_bytes = 0
        for k, a in arrays.items():
            codec = self.policy.select(k, a)
            if codec.name == "none":
                out[k] = a
                continue
            a = np.asarray(a)
            packed = pack_frames(codec.name, codec.encode(k, a))
            out[k] = packed
            enc.append(k)
            raw_bytes += a.nbytes
            enc_bytes += packed.nbytes
        if enc and self.stats is not None:
            self.stats.record_codec(raw_bytes, enc_bytes,
                                    time.perf_counter() - t0)
            self.stats.record_residual_norm(self.policy.residual_norm())
        return out, enc
