"""Buffer-feedback rate control (RM8-style virtual buffer).

Port of `p64tpu/control/ratecontrol.py`, the same integer law:

  target  = bit_rate // frame_rate                  (bits per coded frame)
  qdfact  = max(1, target // 31)
  at each GOB start:   q = clip(buffer // qdfact + qoffs, 1, 31)
  after each GOB:      buffer += gob_bits (header included)
  after each frame:    buffer += picture_header_bits - target, clamped >= 0
  frame skip:          while buffer > skip_threshold * target, skip an input
                       frame (TR advances; buffer -= target, clamped >= 0)

`bit_rate <= 0` is the fixed-quantizer path (the reference's -q): one
quantizer for every GOB, no skip, no stuffing fill.

Every function takes the (S,) int32 buffer vector of S independent streams.
torch's `//` floors, as `jnp`'s does; every dividend here is >= 0 (the
buffer is clamped at the drains and `stuff_count` clamps its deficit first),
so floor and truncation agree anyway.
"""

from __future__ import annotations

import dataclasses

import torch

from ..spec.constants import QUANT_MAX, QUANT_MIN


@dataclasses.dataclass(frozen=True)
class RateConfig:
    """Rate-control parameters (the reference's fields and defaults).

    bit_rate <= 0 disables rate control (fixed quantizer mode);
    skip_threshold_x is the buffer-fullness multiple of `target` above which
    input frames are skipped.
    """

    bit_rate: int = 0
    frame_rate: int = 30
    qoffs: int = 1
    skip_threshold_x: int = 4
    fixed_quant: int = 8
    #: mid-GOB quantizer adaptation: each GOB is split into this many
    #: segments (transmission order); a later segment re-evaluates the
    #: buffer law including the modeled bits of earlier segments, and a
    #: changed quantizer is signaled with MQUANT on the segment's first
    #: coefficient-bearing MB.  1 = one quantizer per GOB (GQUANT only).
    mquant_segments: int = 1
    #: quantizer the very first GOB should see (seeds the virtual buffer)
    initial_quant: int = 8
    #: minimum-rate fill: pad a coded frame that leaves the buffer in
    #: deficit with 11-bit MBA stuffing codes until the buffer is >= 0
    min_rate_fill: bool = True

    def initial_buffer(self) -> int:
        if not self.enabled:
            return 0
        return max(0, (self.initial_quant - self.qoffs) * self.qdfact)

    @property
    def enabled(self) -> bool:
        return self.bit_rate > 0

    @property
    def target_bits_per_frame(self) -> int:
        return max(1, self.bit_rate // self.frame_rate)

    @property
    def qdfact(self) -> int:
        return max(1, self.target_bits_per_frame // 31)


def gob_quant(cfg: RateConfig, buffer_bits: torch.Tensor) -> torch.Tensor:
    """QUANT for the next GOB from each stream's buffer fullness (int32).
    Without rate control, the fixed quantizer clamped to 1..31 (GQUANT 0 is
    forbidden on the wire)."""
    if not cfg.enabled:
        q = min(max(cfg.fixed_quant, QUANT_MIN), QUANT_MAX)
        return torch.full_like(buffer_bits, q, dtype=torch.int32)
    q = buffer_bits.to(torch.int32) // cfg.qdfact + cfg.qoffs
    return q.clamp(QUANT_MIN, QUANT_MAX).to(torch.int32)


#: bits per MBA stuffing code (H.261 Table 1: '00000001111')
STUFF_BITS = 11


def stuff_count(cfg: RateConfig, buffer_bits: torch.Tensor,
                picture_header_bits: int) -> torch.Tensor:
    """Number of MBA stuffing codes needed at the end of this coded frame so
    the post-drain buffer is non-negative (minimum-rate fill).

    buffer_bits: the buffer *including* this frame's GOB bits but before
    the per-frame drain (the value drain_after_frame receives).  Always 0
    when fill is off.
    """
    if not (cfg.enabled and cfg.min_rate_fill):
        return torch.zeros_like(buffer_bits, dtype=torch.int32)
    b = (buffer_bits.to(torch.int32) + picture_header_bits
         - cfg.target_bits_per_frame)
    deficit = (-b).clamp(min=0)
    return ((deficit + STUFF_BITS - 1) // STUFF_BITS).to(torch.int32)


def drain_after_frame(cfg: RateConfig, buffer_bits: torch.Tensor,
                      picture_header_bits: int) -> torch.Tensor:
    """Apply the per-frame drain (call after all GOB bits were added)."""
    b = buffer_bits + picture_header_bits - cfg.target_bits_per_frame
    return b.clamp(min=0).to(torch.int32)


def should_skip(cfg: RateConfig, buffer_bits: torch.Tensor) -> torch.Tensor:
    """True where the encoder should skip the next input frame."""
    if not cfg.enabled:
        return torch.zeros_like(buffer_bits, dtype=torch.bool)
    return buffer_bits > cfg.skip_threshold_x * cfg.target_bits_per_frame


def drain_skipped(cfg: RateConfig, buffer_bits: torch.Tensor) -> torch.Tensor:
    b = buffer_bits - cfg.target_bits_per_frame
    return b.clamp(min=0).to(torch.int32)
