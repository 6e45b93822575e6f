"""The port's configuration knobs — the subset of :class:`tpfl.settings.Settings`
that the ported modules read, with the reference's names, defaults and
docs.

Values are read at use time (per ``run_rounds`` call), so assigning
``Settings.X`` between windows takes effect on the next one. Knobs are
added here as the modules that read them are ported.
"""

from __future__ import annotations


class Settings:
    """Class-level configuration constants, mutable at run time."""

    WIRE_TOPK_FRAC: float = 0.05
    """Fraction of entries per leaf the "topk" codec keeps (by
    magnitude). Only read when the codec includes "topk"."""

    ENGINE_WIRE_CODEC: str = "dense"
    """Device-side wire codec for the engine's gossip exchange
    (tpfl_torch.parallel.engine + tpfl_torch.learning.compression):
    "dense" (default), "quant8", "topk", or "topk+quant8". Non-dense
    runs the payload codec inside the round — each node's trained
    params pass the per-leaf int8-quantize→dequantize (or top-k mask)
    round trip before the fold, so every node folds what a receiver
    would decode. Lossy, like the host-side codec it mirrors (same
    arithmetic, same per-leaf policy); "dense" runs the round with no
    codec op at all. Entropy coders (zlib/zstd) and delta are host byte
    transforms and are rejected here at knob-read time. Read per
    ``run_rounds`` call; the top-k fraction rides ``WIRE_TOPK_FRAC``."""


__all__ = ["Settings"]
