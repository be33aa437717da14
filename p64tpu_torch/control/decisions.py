"""Macroblock mode decisions (intra/inter, MC/no-MC, filter, forced update).

Port of `p64tpu/control/decisions.py`; the rules, vectorized over streams
and macroblocks:

  activity   var_or   = (sum(c^2)  - sum(c)^2  // 256) // 256   (original MB)
             var_diff = (sum(d^2)  - sum(d)^2  // 256) // 256   (d = MB - pred)
  MC         use_mc   iff  best_sad * mc_num < sad0 * mc_den  and mv != 0
  intra      var_diff > inter_var_floor  and  var_or < var_diff
  filter     on whenever MC is used (cfg.filter_with_mc)
  forced     refresh counter >= INTRA_REFRESH_PERIOD - 1 forces intra
"""

from __future__ import annotations

import dataclasses

import torch

from ..spec.constants import INTRA_REFRESH_PERIOD


@dataclasses.dataclass(frozen=True)
class DecisionConfig:
    """RM8-inspired decision constants (the JAX package's values)."""

    mc_num: int = 107          # use MC iff best_sad * mc_num < sad0 * mc_den
    mc_den: int = 100
    inter_var_floor: int = 64  # var_diff <= floor => always inter
    filter_with_mc: bool = True


def _sq_div256(s1: torch.Tensor) -> torch.Tensor:
    """Exact s1*s1 // 256 in int32 without overflow: |s1| reaches 65280,
    whose square wraps int32.  With a = |s1| = 256*q + r,
    a^2 // 256 == 256*q*q + 2*q*r + (r*r) // 256, all terms < 2^25.  Kept
    although torch has int64, so that an int32 kernel can share it."""
    a = s1.abs()
    q = a >> 8
    r = a & 255
    return 256 * q * q + 2 * q * r + (r * r) // 256


def _var(x: torch.Tensor) -> torch.Tensor:
    """(sum(x^2) - sum(x)^2 // 256) // 256 over the last two axes, int32."""
    s1 = x.sum(dim=(-2, -1), dtype=torch.int32)
    s2 = (x * x).sum(dim=(-2, -1), dtype=torch.int32)
    return (s2 - _sq_div256(s1)) // 256


def activity(pixels: torch.Tensor) -> torch.Tensor:
    """Integer per-MB activity over the last two (16, 16) axes."""
    return _var(pixels.to(torch.int32))


def decide_modes(cur_mbs: torch.Tensor,
                 pred0_mbs: torch.Tensor,
                 predmv_mbs: torch.Tensor,
                 sad0: torch.Tensor,
                 best_sad: torch.Tensor,
                 mv: torch.Tensor,
                 refresh_count: torch.Tensor,
                 force_intra_frame: torch.Tensor,
                 cfg: DecisionConfig = DecisionConfig()):
    """Choose per-MB coding modes.

    Args:
      cur_mbs, pred0_mbs, predmv_mbs: (S, nMB, 16, 16) current luma, zero-MV
        prediction, best-MV prediction (unfiltered).
      sad0, best_sad: (S, nMB); mv: (S, nMB, 2) -- full-search outputs.
      refresh_count: (S, nMB) int32 forced-update counters.
      force_intra_frame: (S,) bool (first frame / intra period).

    Returns dict with intra, use_mc, fil ((S, nMB) bool), mv_out
    ((S, nMB, 2), zeroed where MC unused), var_or, var_diff.
    """
    nonzero_mv = (mv != 0).any(dim=-1)
    use_mc = (best_sad * cfg.mc_num < sad0 * cfg.mc_den) & nonzero_mv

    pred = torch.where(use_mc[..., None, None], predmv_mbs, pred0_mbs)
    var_or = activity(cur_mbs)
    var_diff = _var(cur_mbs.to(torch.int32) - pred.to(torch.int32))

    forced = refresh_count >= (INTRA_REFRESH_PERIOD - 1)
    intra = (force_intra_frame[:, None]
             | forced
             | ((var_diff > cfg.inter_var_floor) & (var_or < var_diff)))
    use_mc = use_mc & ~intra
    fil = use_mc & cfg.filter_with_mc
    mv_out = torch.where(use_mc[..., None], mv, torch.zeros_like(mv))
    return dict(intra=intra, use_mc=use_mc, fil=fil, mv_out=mv_out,
                var_or=var_or, var_diff=var_diff)
