"""Gradient codecs: one ``encode/decode`` contract, four implementations.

Counterpart of ``ps_tpu/compress/codecs.py``. A codec turns one tensor
into a dict of named numpy ``frames`` that alone determine the decoded
tensor (decode needs no state of the sender), and back. Lossy codecs
bound their error per encode; ``topk`` also keeps worker-local
error-feedback residuals, so what is not sent this step is sent later.

Every codec passes through (frame ``"raw"``) what it cannot represent:
anything but float32. Non-finite values: ``cast16`` keeps NaN and Inf;
``int8`` saturates +-Inf to the chunk's +-max and maps NaN to 0 (scales
come from the finite entries only); ``topk`` ranks NaN as 0.

The reference's bf16 cast goes through ``ml_dtypes``; numpy has no
bfloat16, so this module rounds float32 to bf16 bit patterns itself,
round to nearest even, a NaN to the quiet NaN of its sign (0x7FC0 or
0xFFC0), which is what ``ml_dtypes`` produces bit for bit.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np


def _contig(arr) -> np.ndarray:
    # ascontiguousarray alone would promote 0-d scalars to 1-d
    a = np.asarray(arr)
    return np.ascontiguousarray(a).reshape(a.shape)


def f32_to_bf16_bits(arr: np.ndarray) -> np.ndarray:
    """Float32 -> bfloat16 bit patterns (uint16), round to nearest even."""
    a = _contig(arr)
    u = a.view(np.uint32)
    # uint32 arithmetic wraps only for negative NaNs, which are set below
    out = ((u + (((u >> 16) & 1) + np.uint32(0x7FFF))) >> 16).astype(
        np.uint16)
    nan = np.isnan(a)
    if nan.any():
        out[nan] = (((u[nan] >> 16) & 0x8000) | 0x7FC0).astype(np.uint16)
    return out


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) -> float32, exact."""
    return (np.asarray(bits).astype(np.uint32) << 16).view(np.float32)


class Codec:
    """One gradient codec: ``encode(key, ndarray) -> frames`` and
    ``decode(frames) -> ndarray``. ``key`` lets a stateful codec (topk's
    error feedback) keep per-tensor state; ``decode`` is stateless for
    every codec."""

    name = "?"
    #: True when decode(encode(x)) == x exactly for every input
    lossless = False

    def encode(self, key: str, arr) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def decode(self, frames: Dict[str, np.ndarray]) -> np.ndarray:
        raise NotImplementedError

    def residual_norm(self) -> float:
        """L2 norm of this codec's error-feedback state (0 if stateless)."""
        return 0.0

    def _raw(self, arr) -> Dict[str, np.ndarray]:
        return {"raw": _contig(arr)}

    def _is_raw(self, frames) -> Optional[np.ndarray]:
        return frames.get("raw")


class NoneCodec(Codec):
    """The identity: 'do not compress', and every codec's passthrough."""

    name = "none"
    lossless = True

    def encode(self, key: str, arr) -> Dict[str, np.ndarray]:
        return self._raw(arr)

    def decode(self, frames: Dict[str, np.ndarray]) -> np.ndarray:
        return frames["raw"]


class Cast16Codec(Codec):
    """Float32 -> 16 bits (2x). ``mode='bf16'`` (default: f32's exponent
    range) ships uint16 bit patterns; ``'fp16'`` numpy's float16. Lossless
    on values already on the 16-bit grid."""

    name = "cast16"

    def __init__(self, mode: str = "bf16"):
        if mode not in ("bf16", "fp16"):
            raise ValueError(f"cast16 mode {mode!r}; use 'bf16' or 'fp16'")
        self.mode = mode

    def encode(self, key: str, arr) -> Dict[str, np.ndarray]:
        arr = _contig(arr)
        if arr.dtype != np.float32:
            return self._raw(arr)
        if self.mode == "bf16":
            return {"bf16": f32_to_bf16_bits(arr)}
        return {"fp16": arr.astype(np.float16)}

    def decode(self, frames: Dict[str, np.ndarray]) -> np.ndarray:
        raw = self._is_raw(frames)
        if raw is not None:
            return raw
        if "bf16" in frames:
            return bf16_bits_to_f32(frames["bf16"])
        return frames["fp16"].astype(np.float32)


class Int8Codec(Codec):
    """Per-chunk scale quantization to int8 (~4x), QSGD-style: each
    ``chunk``-element run gets the scale ``max|x| / 127`` and values round
    stochastically (``floor(x/scale + u)``, ``u ~ U[0,1)`` from the
    codec's own ``np.random.default_rng(seed)``), so E[decode] == x and
    the error of one encode is at most one step, ``max|chunk| / 127``."""

    name = "int8"

    def __init__(self, chunk: int = 1024, stochastic: bool = True,
                 seed: int = 0):
        self.chunk = max(int(chunk), 1)
        self.stochastic = bool(stochastic)
        self._rng = np.random.default_rng(seed)

    def encode(self, key: str, arr) -> Dict[str, np.ndarray]:
        arr = _contig(arr)
        if arr.dtype != np.float32:
            return self._raw(arr)
        flat = arr.reshape(-1)
        n = flat.size
        nchunks = -(-n // self.chunk) if n else 0
        if nchunks:
            pad = np.zeros(nchunks * self.chunk, np.float32)
            np.absolute(flat, out=pad[:n], where=np.isfinite(flat))
            scales = (pad.reshape(nchunks, self.chunk).max(axis=1)
                      / 127.0).astype(np.float32)
        else:
            scales = np.zeros(0, np.float32)
        safe = np.where(scales > 0, scales, 1.0)
        r = flat / np.repeat(safe, self.chunk)[:n]
        r = np.nan_to_num(r, nan=0.0, posinf=127.0, neginf=-127.0)
        if self.stochastic and n:
            q = np.floor(r + self._rng.random(n, dtype=np.float32))
        else:
            q = np.rint(r)
        q = np.clip(q, -127, 127).astype(np.int8)
        return {
            "q8": q,
            "scale": scales,
            "shape": np.asarray(arr.shape, np.int64),
            "chunk": np.asarray([self.chunk], np.int64),
        }

    def decode(self, frames: Dict[str, np.ndarray]) -> np.ndarray:
        raw = self._is_raw(frames)
        if raw is not None:
            return raw
        q = frames["q8"]
        scales = frames["scale"].astype(np.float32)
        chunk = int(frames["chunk"][0])
        shape = tuple(int(s) for s in frames["shape"])
        x = q.astype(np.float32) * np.repeat(scales, chunk)[:q.size]
        return x.reshape(shape)


class TopKCodec(Codec):
    """Per-tensor top-k with error feedback (DGC-style): only the
    ``k = ceil(fraction * n)`` largest magnitudes travel (exact values,
    as int32 index + f32 value); the rest accumulate in a worker-local
    per-key residual added to the next gradient before selection.
    ``error_feedback=False`` drops them instead."""

    name = "topk"

    def __init__(self, fraction: float = 0.01, error_feedback: bool = True):
        if not (0.0 < fraction <= 1.0):
            raise ValueError(f"topk fraction {fraction} outside (0, 1]")
        self.fraction = float(fraction)
        self.error_feedback = bool(error_feedback)
        self._residual: Dict[str, np.ndarray] = {}

    def encode(self, key: str, arr) -> Dict[str, np.ndarray]:
        arr = _contig(arr)
        if arr.dtype != np.float32 or arr.size >= 2 ** 31:
            return self._raw(arr)
        flat = arr.reshape(-1).copy()
        res = self._residual.get(key)
        if self.error_feedback and res is not None and res.size == flat.size:
            flat += res
        n = flat.size
        k = min(n, max(1, math.ceil(self.fraction * n))) if n else 0
        if k and k < n:
            mag = np.abs(np.nan_to_num(flat, nan=0.0))
            idx = np.argpartition(mag, n - k)[n - k:]
            idx.sort()  # a deterministic order
        else:
            idx = np.arange(n)
        val = flat[idx]
        if self.error_feedback:
            flat[idx] = 0.0
            self._residual[key] = flat
        return {
            "idx": idx.astype(np.int32),
            "val": val,
            "shape": np.asarray(arr.shape, np.int64),
        }

    def decode(self, frames: Dict[str, np.ndarray]) -> np.ndarray:
        raw = self._is_raw(frames)
        if raw is not None:
            return raw
        shape = tuple(int(s) for s in frames["shape"])
        out = np.zeros(int(np.prod(shape, dtype=np.int64)), np.float32)
        out[frames["idx"]] = frames["val"]
        return out.reshape(shape)

    def residual_norm(self) -> float:
        if not self._residual:
            return 0.0
        return float(math.sqrt(sum(
            float(np.dot(r, r)) for r in self._residual.values())))


_REGISTRY = {
    "none": NoneCodec,
    "cast16": Cast16Codec,
    "int8": Int8Codec,
    "topk": TopKCodec,
}


def available_codecs():
    return sorted(_REGISTRY)


def make_codec(name: str, **kwargs) -> Codec:
    """A codec by wire name (kwargs go to its constructor)."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r}; available: {available_codecs()}"
        ) from None
    return cls(**kwargs)
