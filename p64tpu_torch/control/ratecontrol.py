"""Rate control: the fixed-quantizer case.

Port of `p64tpu/control/ratecontrol.py` for `bit_rate <= 0`, the reference's
-q path: one quantizer for every GOB, no frame skip, no stuffing fill.  The
virtual buffer still drains after each frame exactly as in the reference,
because it is part of the encoder state that both packages carry.  The
buffer law for `bit_rate > 0` is not ported yet; `EncoderConfig` refuses it.
"""

from __future__ import annotations

import dataclasses

import torch

from p64tpu.spec.constants import QUANT_MAX, QUANT_MIN


@dataclasses.dataclass(frozen=True)
class RateConfig:
    """Rate-control parameters: the reference's fields that the fixed-q
    path reads.  bit_rate <= 0 disables rate control (fixed quantizer);
    the buffer-law fields come with the rate-control port."""

    bit_rate: int = 0
    frame_rate: int = 30
    fixed_quant: int = 8

    @property
    def enabled(self) -> bool:
        return self.bit_rate > 0

    @property
    def target_bits_per_frame(self) -> int:
        return max(1, self.bit_rate // self.frame_rate)


def _require_disabled(cfg: RateConfig) -> None:
    if cfg.enabled:
        raise NotImplementedError(
            "rate control (bit_rate > 0) is not ported yet")


def gob_quant(cfg: RateConfig, buffer_bits: torch.Tensor) -> torch.Tensor:
    """QUANT for the next GOB, per stream: the fixed quantizer clamped to
    1..31 (GQUANT 0 is forbidden on the wire)."""
    _require_disabled(cfg)
    q = min(max(cfg.fixed_quant, QUANT_MIN), QUANT_MAX)
    return torch.full_like(buffer_bits, q, dtype=torch.int32)


#: bits per MBA stuffing code (H.261 Table 1: '00000001111')
STUFF_BITS = 11


def stuff_count(cfg: RateConfig, buffer_bits: torch.Tensor,
                picture_header_bits: int) -> torch.Tensor:
    """MBA stuffing codes at the end of a coded frame: none without rate
    control."""
    _require_disabled(cfg)
    return torch.zeros_like(buffer_bits, dtype=torch.int32)


def drain_after_frame(cfg: RateConfig, buffer_bits: torch.Tensor,
                      picture_header_bits: int) -> torch.Tensor:
    """Apply the per-frame drain (call after all GOB bits were added)."""
    b = buffer_bits + picture_header_bits - cfg.target_bits_per_frame
    return b.clamp(min=0).to(torch.int32)


def should_skip(cfg: RateConfig, buffer_bits: torch.Tensor) -> torch.Tensor:
    """True where the encoder should skip the next input frame: never
    without rate control."""
    _require_disabled(cfg)
    return torch.zeros_like(buffer_bits, dtype=torch.bool)


def drain_skipped(cfg: RateConfig, buffer_bits: torch.Tensor) -> torch.Tensor:
    b = buffer_bits - cfg.target_bits_per_frame
    return b.clamp(min=0).to(torch.int32)
