"""Gradient codecs for the van transport.

Counterpart of ``ps_tpu/compress/``: ``cast16`` (a bf16/fp16 downcast),
``int8`` (per-chunk stochastic scale quantization, QSGD-style) and
``topk`` (per-tensor top-k with worker-local error-feedback residuals),
behind one ``encode(key, ndarray) -> frames`` / ``decode(frames) ->
ndarray`` contract. The codecs run in numpy on the host, as the
reference's do: an int8 frame draws the same numpy random stream for the
same seed, so the port's frames are the reference's, byte for byte.

An encoded tensor travels as one packed uint8 buffer (:func:`pack_frames`:
codec name and each frame's dtype and shape in a json header), so it
rides the serial and bucketed transports unchanged; the packed keys ride
the frame's header (``extra["enc"]``) and the receiver decodes them with
:func:`decode_tree`. :class:`CompressPolicy` picks the codec per key and
:class:`GradCompressor` applies it on the worker.
"""

from ps_tpu_torch.compress.codecs import (
    Cast16Codec,
    Codec,
    Int8Codec,
    NoneCodec,
    TopKCodec,
    available_codecs,
    make_codec,
)
from ps_tpu_torch.compress.policy import CompressPolicy, resolve_spec
from ps_tpu_torch.compress.wire import (
    GradCompressor,
    decode_packed,
    decode_tree,
    pack_frames,
    unpack_frames,
)

__all__ = [
    "Codec", "NoneCodec", "Cast16Codec", "Int8Codec", "TopKCodec",
    "available_codecs", "make_codec",
    "CompressPolicy", "resolve_spec",
    "GradCompressor", "decode_tree", "decode_packed",
    "pack_frames", "unpack_frames",
]
