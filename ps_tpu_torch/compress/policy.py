"""Per-key codec selection: compress where it pays, never where it hurts.

Counterpart of ``ps_tpu/compress/policy.py``. The policy owns one shared
instance of its lossy codec (so topk's residuals persist across steps)
and the identity, and picks per (key, tensor) with three gates: tensors
under ``min_bytes`` stay raw (biases, norms, scalars: quantization noise
hurts most there and the saving is noise), only float32 compresses, and
keys matching an ``exclude`` regex stay raw.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Union

import numpy as np

from ps_tpu_torch.compress.codecs import Codec, NoneCodec, make_codec

#: default size floor: below it framing overhead and optimizer
#: sensitivity both say "don't"
DEFAULT_MIN_BYTES = 1 << 16

Spec = Union[None, str, dict]


def resolve_spec(spec: Spec, *, topk: Optional[float] = None,
                 min_bytes: Optional[int] = None,
                 pull: Optional[bool] = None) -> Optional[dict]:
    """A compression spec as a dict, or None for off.

    ``spec`` is a codec name (``"int8"``), a dict (``{"codec": "topk",
    "topk": 0.02, "min_bytes": 4096, "pull": False}``) or
    None/"none"/"". The keyword overrides (the config and env knobs) win
    over the dict's fields."""
    if spec is None or spec == "" or spec == "none":
        return None
    out = dict(spec) if isinstance(spec, dict) else {"codec": str(spec)}
    if out.get("codec") in (None, "", "none"):
        return None
    if topk is not None:
        out["topk"] = float(topk)
    if min_bytes is not None:
        out["min_bytes"] = int(min_bytes)
    if pull is not None:
        out["pull"] = bool(pull)
    return out


class CompressPolicy:
    """The codec for each (key, tensor).

    Args:
      codec: wire codec name ('none'/'cast16'/'int8'/'topk').
      min_bytes: size floor below which tensors stay raw.
      topk: kept fraction for 'topk'.
      exclude: regexes; matching keys stay raw.
      error_feedback: topk's residual accumulation.
      seed: int8's stochastic-rounding seed.
    """

    def __init__(self, codec: str = "none",
                 min_bytes: int = DEFAULT_MIN_BYTES,
                 topk: float = 0.01,
                 exclude: Sequence[str] = (),
                 error_feedback: bool = True,
                 seed: int = 0):
        self.min_bytes = max(int(min_bytes), 0)
        self._exclude = [re.compile(p) for p in exclude]
        kwargs: Dict = {}
        if codec == "topk":
            kwargs = {"fraction": topk, "error_feedback": error_feedback}
        elif codec == "int8":
            kwargs = {"seed": seed}
        self.codec: Codec = make_codec(codec, **kwargs)
        self._none = NoneCodec()

    @classmethod
    def from_spec(cls, spec: Spec, **kwargs) -> Optional["CompressPolicy"]:
        """From a spec dict or name; None when off."""
        spec = resolve_spec(spec)
        if spec is None:
            return None
        return cls(
            codec=spec["codec"],
            min_bytes=spec.get("min_bytes", DEFAULT_MIN_BYTES),
            topk=spec.get("topk", 0.01),
            exclude=spec.get("exclude", ()),
            error_feedback=spec.get("error_feedback", True),
            seed=spec.get("seed", 0),
            **kwargs,
        )

    @property
    def enabled(self) -> bool:
        return self.codec.name != "none"

    def select(self, key: str, arr) -> Codec:
        if not self.enabled:
            return self._none
        arr = np.asarray(arr)
        if arr.nbytes < self.min_bytes or arr.dtype != np.float32:
            return self._none
        if any(p.search(key) for p in self._exclude):
            return self._none
        return self.codec

    def residual_norm(self) -> float:
        return self.codec.residual_norm()
