"""H.261 encoder, fixed quantizer: whole frames as tensors on the device.

Port of `p64tpu/core/encoder.py` for rate control off.  Per frame, for a
batch of S independent streams at once:

    1. full-search ME over all MBs          (kernels.me -> CUDA kernel)
    2. mode decisions                       (control.decisions)
    3. MC prediction + loop filter          (core.predict)
    4. residual -> integer DCT              (kernels.dct)
    5. quantize, CBP/MTYPE/coded masks and the EXACT bit cost of every GOB
       at once (no cross-GOB dependency at a fixed quantizer)
                                            (kernels.quant, entropy.lengths)
    6. local reconstruction                 (core.reconstruct)

The frame loop is a host `for` loop carrying the state (the reference's
`lax.scan`); the stream axis is explicit (the reference's `vmap`).  The
host then serializes each stream (entropy.encode) and asserts that it
emitted exactly the device's bit count.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from p64tpu.spec.constants import (
    DEFAULT_SEARCH_RANGE,
    INTRA_DC_MAX,
    INTRA_DC_MIN,
    LEVEL_CLAMP,
    MBS_PER_GOB,
    Format,
)
from p64tpu.spec.tables import MTYPE_BY_NAME

from ..control.decisions import DecisionConfig, decide_modes
from ..control.ratecontrol import (
    STUFF_BITS,
    RateConfig,
    drain_after_frame,
    gob_quant,
    stuff_count,
)
from ..entropy import lengths
from ..entropy.encode import FrameSymbols, serialize_sequence
from ..kernels.dct import fdct8x8_zz
from ..kernels.me import full_search
from ..kernels.quant import quantize_zz
from ..utils import device_const
from .blocks import (
    assemble_blocks,
    assemble_mb_blocks,
    chroma_to_blocks,
    from_gob_order,
    luma_to_mbs,
    to_gob_order,
)
from .predict import _apply_filter, mc_predict
from .reconstruct import reconstruct_frame

# levels ship as int8 plus a uint8 intra-DC sidecar; lossless only while the
# quantizer clamps hold (ACs and inter DC within +/-127, intra DC 0..255)
assert LEVEL_CLAMP <= 127, "levels8 int8 packing requires |level| <= 127"
assert 0 <= INTRA_DC_MIN and INTRA_DC_MAX <= 255, \
    "dc_intra uint8 sidecar requires intra DC within 0..255"

_MT = MTYPE_BY_NAME
_CBP_WEIGHTS = np.asarray([32, 16, 8, 4, 2, 1], np.int32)

#: output keys that carry reconstructed planes (emit_recon)
RECON_KEYS = ("recon_y", "recon_cb", "recon_cr")

State = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    fmt: Format
    search: int = DEFAULT_SEARCH_RANGE
    rate: RateConfig = RateConfig()
    decisions: DecisionConfig = DecisionConfig()
    intra_only: bool = False     # no ME / no inter path at all
    intra_period: int = 0        # >0: force an all-intra frame every N
    #: emit per-frame reconstructed planes in the outputs (the planes are
    #: always computed -- they are the reference state -- but keeping one
    #: copy per frame costs (S, T, H, W) x 1.5 bytes of device memory)
    emit_recon: bool = True

    def __post_init__(self):
        if not 0 <= self.search <= DEFAULT_SEARCH_RANGE:
            raise ValueError(
                f"search must be 0..{DEFAULT_SEARCH_RANGE} (H.261 MV range);"
                f" got {self.search}")
        if self.rate.enabled:
            raise NotImplementedError(
                "rate control (bit_rate > 0) is not ported yet; use a fixed "
                "quantizer")


# ---------------------------------------------------------------------------
# encoder state
# ---------------------------------------------------------------------------


def init_state(cfg: EncoderConfig, streams: int,
               device: torch.device | str) -> State:
    fmt = cfg.fmt
    ch = (streams, fmt.chroma_height, fmt.chroma_width)
    return dict(
        ref_y=torch.zeros((streams, fmt.height, fmt.width), dtype=torch.uint8,
                          device=device),
        ref_cb=torch.zeros(ch, dtype=torch.uint8, device=device),
        ref_cr=torch.zeros(ch, dtype=torch.uint8, device=device),
        refresh=torch.zeros((streams, fmt.num_mbs), dtype=torch.int32,
                            device=device),
        # rate control off: the virtual buffer starts empty
        buffer=torch.zeros((streams,), dtype=torch.int32, device=device),
        frame_idx=torch.zeros((streams,), dtype=torch.int32, device=device),
    )


_STATE_DTYPES = dict(ref_y=torch.uint8, ref_cb=torch.uint8,
                     ref_cr=torch.uint8, refresh=torch.int32,
                     buffer=torch.int32, frame_idx=torch.int32)


def state_from_numpy(d: Mapping[str, np.ndarray],
                     device: torch.device | str) -> State:
    """Encoder state from numpy arrays laid out as the JAX package's
    `init_state` (ref_y/ref_cb/ref_cr uint8 planes, refresh (nMB,) int32,
    buffer and frame_idx int32 scalars), with or without a leading stream
    axis -- so both packages can resume from the same mid-sequence state."""
    batched = np.asarray(d["ref_y"]).ndim == 3
    out = {}
    for k, dt in _STATE_DTYPES.items():
        a = np.array(d[k])               # a writable copy for torch
        if not batched:
            a = a[None]
        out[k] = torch.as_tensor(a, device=device).to(dt).contiguous()
    return out


def state_to_numpy(state: State) -> Dict[str, np.ndarray]:
    """The state as numpy arrays with a leading stream axis (slice stream s
    with `{k: v[s] for k, v in ...}` for the JAX package's layout)."""
    return {k: state[k].cpu().numpy() for k in _STATE_DTYPES}


# ---------------------------------------------------------------------------
# one coded picture
# ---------------------------------------------------------------------------


def _mtype_from_flags(intra, use_mc, fil, has_coef):
    mt = torch.full(intra.shape, _MT["inter"], dtype=torch.int32,
                    device=intra.device)
    mt = torch.where(use_mc & ~fil & has_coef, _MT["inter_mc_coef"], mt)
    mt = torch.where(use_mc & ~fil & ~has_coef, _MT["inter_mc"], mt)
    mt = torch.where(use_mc & fil & has_coef, _MT["inter_fil_coef"], mt)
    mt = torch.where(use_mc & fil & ~has_coef, _MT["inter_fil"], mt)
    return torch.where(intra, _MT["intra"], mt)


def _quantize_derive(coefs_t, intra_t, mc_t, fil_t, q):
    """Quantize at q and derive (levels, cbp, coded, mtype) -- the
    reference's single home for these rules (`quantize_derive`)."""
    levels = quantize_zz(coefs_t, q, intra_t[..., None, None])
    weights = device_const(_CBP_WEIGHTS, levels.device)
    cbp = torch.where((levels != 0).any(dim=-1), weights, 0).sum(
        dim=-1, dtype=torch.int32)
    has_coef = cbp > 0
    coded = intra_t | mc_t | has_coef
    levels = torch.where(coded[..., None, None], levels, 0)
    mtype = _mtype_from_flags(intra_t, mc_t, fil_t, has_coef)
    return levels, cbp, coded, mtype


def _encode_picture(cfg: EncoderConfig, state: State, cur_y: torch.Tensor,
                    cur_cb: torch.Tensor, cur_cr: torch.Tensor):
    """One coded picture for every stream.  cur_*: (S, H, W) and
    (S, H/2, W/2) uint8, contiguous.  Returns (new_state, out)."""
    fmt = cfg.fmt
    s, n_mb = cur_y.shape[0], fmt.num_mbs
    dev = cur_y.device
    cur_mbs = luma_to_mbs(cur_y.to(torch.int32))           # (S, nMB, 16, 16)

    force_intra = state["frame_idx"] == 0
    if cfg.intra_period > 0:
        force_intra = force_intra | (state["frame_idx"] % cfg.intra_period
                                     == 0)

    # zero-MV prediction = the reference planes themselves
    pred0_y = luma_to_mbs(state["ref_y"].to(torch.int32))
    pred0_cb = chroma_to_blocks(state["ref_cb"].to(torch.int32))
    pred0_cr = chroma_to_blocks(state["ref_cr"].to(torch.int32))

    if cfg.intra_only:
        intra = torch.ones((s, n_mb), dtype=torch.bool, device=dev)
        use_mc = torch.zeros_like(intra)
        fil = torch.zeros_like(intra)
        mv = torch.zeros((s, n_mb, 2), dtype=torch.int32, device=dev)
        # every MB is intra; the prediction still equals the decoder's
        # zero-MV unfiltered copy
        pred_y, pred_cb, pred_cr = pred0_y, pred0_cb, pred0_cr
    else:
        mv_raw, best_sad, sad0 = full_search(cur_y, state["ref_y"],
                                             cfg.search)
        # one MC gather per frame: the unfiltered best-MV prediction feeds
        # the decisions, and the final prediction is selected from it and
        # filtered -- exactly mc_predict(mv_out, fil)
        pmv_y, pmv_cb, pmv_cr = mc_predict(
            state["ref_y"], state["ref_cb"], state["ref_cr"], mv_raw, None,
            fmt)
        d = decide_modes(cur_mbs, pred0_y, pmv_y, sad0, best_sad, mv_raw,
                         state["refresh"], force_intra, cfg.decisions)
        intra, use_mc, fil, mv = (d["intra"], d["use_mc"], d["fil"],
                                  d["mv_out"])
        sel = use_mc[..., None, None]
        pred_y, pred_cb, pred_cr = _apply_filter(
            torch.where(sel, pmv_y, pred0_y),
            torch.where(sel, pmv_cb, pred0_cb),
            torch.where(sel, pmv_cr, pred0_cr), fil)

    cur_blocks = assemble_mb_blocks(cur_mbs, cur_cb.to(torch.int32),
                                    cur_cr.to(torch.int32))
    pred_blocks = assemble_blocks(pred_y, pred_cb, pred_cr)
    resid = cur_blocks - torch.where(intra[..., None, None, None], 0,
                                     pred_blocks)
    coefs = fdct8x8_zz(resid)                         # (S, nMB, 6, 64)

    # ---- every GOB at once, in transmission order (fixed quantizer) ----
    ngob = fmt.num_gobs
    gq = gob_quant(cfg.rate, state["buffer"])          # (S,)
    gquant = gq[:, None].expand(s, ngob).contiguous()
    levels_t, cbp_t, coded_t, mtype_t = _quantize_derive(
        to_gob_order(fmt, coefs), to_gob_order(fmt, intra),
        to_gob_order(fmt, use_mc), to_gob_order(fmt, fil),
        gquant[:, :, None, None, None])
    gob_bits = lengths.gob_payload_bits(
        coded_t, mtype_t, to_gob_order(fmt, mv), cbp_t,
        levels_t) + lengths.GOB_HEADER_BITS            # (S, nGOB)
    quant_t = gquant[:, :, None].expand(s, ngob, MBS_PER_GOB)
    frame_bits = gob_bits.sum(dim=-1, dtype=torch.int32)
    buffer_after = state["buffer"] + frame_bits

    levels = from_gob_order(fmt, levels_t).to(torch.int16)
    cbp = from_gob_order(fmt, cbp_t)
    mtype = from_gob_order(fmt, mtype_t)
    coded = from_gob_order(fmt, coded_t)
    n_stuff = stuff_count(cfg.rate, buffer_after,
                          lengths.PICTURE_HEADER_BITS)
    buffer_after = buffer_after + STUFF_BITS * n_stuff
    total_bits = (frame_bits + lengths.PICTURE_HEADER_BITS
                  + STUFF_BITS * n_stuff)

    # ---- local reconstruction (shared with the decoder) ----
    quant_mb = from_gob_order(fmt, quant_t)
    # the prediction equals mc_predict(mv, fil & coded): fil implies use_mc
    # implies coded, and uncoded MBs have mv == 0
    rec_y, rec_cb, rec_cr = reconstruct_frame(
        fmt, levels.to(torch.int32), quant_mb, intra & coded, mv,
        fil & coded, state["ref_y"], state["ref_cb"], state["ref_cr"],
        pred=(pred_y, pred_cb, pred_cr))

    refresh = torch.where(coded & intra, 0,
                          torch.where(coded, state["refresh"] + 1,
                                      state["refresh"])).to(torch.int32)
    new_state = dict(
        ref_y=rec_y, ref_cb=rec_cb, ref_cr=rec_cr, refresh=refresh,
        buffer=drain_after_frame(cfg.rate, buffer_after,
                                 lengths.PICTURE_HEADER_BITS),
        frame_idx=state["frame_idx"] + 1,
    )

    # exact integer SSE, reported as float32 like the reference
    diff = rec_y.to(torch.int64) - cur_y.to(torch.int64)
    sse_y = (diff * diff).sum(dim=(-2, -1)).to(torch.float32)
    # ACs and the inter DC fit int8; the intra DC rides a uint8 sidecar
    intra_dc = (intra & coded)[..., None]
    slot0 = torch.arange(64, device=dev) == 0
    levels8 = torch.where(slot0 & intra_dc[..., None], 0, levels).to(
        torch.int8)
    dc_intra = torch.where(intra_dc, levels[..., 0], 0).to(torch.uint8)
    out = dict(
        frame_coded=torch.ones((s,), dtype=torch.bool, device=dev),
        tr=state["frame_idx"] & 31,
        gquant=gquant,
        quant_mb=quant_mb.to(torch.int32),
        coded=coded, mtype=mtype, mv=mv.to(torch.int32), cbp=cbp,
        levels8=levels8, dc_intra=dc_intra,
        total_bits=total_bits.to(torch.int32),
        n_stuff=n_stuff,
        sse_y=sse_y,
    )
    if cfg.emit_recon:
        out.update(recon_y=rec_y, recon_cb=rec_cb, recon_cr=rec_cr)
    return new_state, out


# ---------------------------------------------------------------------------
# sequences
# ---------------------------------------------------------------------------


def _frames_on(frames: Mapping[str, object],
               device: torch.device | str) -> Dict[str, torch.Tensor]:
    out = {}
    for k in ("y", "cb", "cr"):
        t = torch.as_tensor(frames[k], device=device)
        if t.dtype != torch.uint8 or t.dim() != 4:
            raise ValueError(f"frames[{k!r}] must be (S, T, H, W) uint8; got "
                             f"{tuple(t.shape)} {t.dtype}")
        out[k] = t
    return out


def encode_sequence(cfg: EncoderConfig, frames: Mapping[str, object],
                    state: Optional[State] = None, *,
                    device: torch.device | str):
    """Encode S streams of T frames.

    frames: y (S, T, H, W), cb/cr (S, T, H/2, W/2) uint8 (numpy or torch).
    Returns (final_state, outputs) with outputs stacked as (S, T, ...).
    """
    fr = _frames_on(frames, device)
    s, t = fr["y"].shape[:2]
    if state is None:
        state = init_state(cfg, s, device)
    outs = []
    for i in range(t):
        state, out = _encode_picture(
            cfg, state, fr["y"][:, i].contiguous(),
            fr["cb"][:, i].contiguous(), fr["cr"][:, i].contiguous())
        outs.append(out)
    outputs = {k: torch.stack([o[k] for o in outs], dim=1) for k in outs[0]}
    return state, outputs


# ---------------------------------------------------------------------------
# host-side finalize
# ---------------------------------------------------------------------------


def outputs_to_symbols(cfg: EncoderConfig,
                       outputs: Mapping[str, torch.Tensor]
                       ) -> List[List[FrameSymbols]]:
    """Stacked (S, T, ...) device outputs -> per stream, the FrameSymbols of
    its coded frames, ready for entropy.encode.serialize_sequence."""
    host = {k: v.cpu().numpy() for k, v in outputs.items()
            if k not in RECON_KEYS}
    streams = []
    for si in range(host["frame_coded"].shape[0]):
        syms = []
        for i in range(host["frame_coded"].shape[1]):
            if not host["frame_coded"][si, i]:
                continue
            # reassemble int16 levels from the int8 tensor + intra-DC
            # sidecar (nonzero exactly on intra coded MBs: DC FLC >= 1)
            lv = host["levels8"][si, i].astype(np.int16)
            dc = host["dc_intra"][si, i].astype(np.int16)
            lv[..., 0] = np.where(dc > 0, dc, lv[..., 0])
            syms.append(FrameSymbols(
                tr=int(host["tr"][si, i]), gquant=host["gquant"][si, i],
                coded=host["coded"][si, i], mtype=host["mtype"][si, i],
                mv=host["mv"][si, i], cbp=host["cbp"][si, i],
                levels=lv, quant_mb=host["quant_mb"][si, i],
                n_stuff=int(host["n_stuff"][si, i])))
        streams.append(syms)
    return streams


def encode_to_bytes(cfg: EncoderConfig, frames: Mapping[str, object],
                    state: Optional[State] = None, *,
                    device: torch.device | str
                    ) -> Tuple[List[bytes], Dict[str, torch.Tensor], State]:
    """Full pipeline: device encode + host serialize, per stream.

    Returns (stream_bytes per stream, outputs, final_state); raises if the
    serializer did not emit exactly the device-predicted bit count.
    """
    final_state, outputs = encode_sequence(cfg, frames, state, device=device)
    predicted = outputs["total_bits"].sum(dim=1).tolist()
    data = []
    for si, syms in enumerate(outputs_to_symbols(cfg, outputs)):
        b, nbits = serialize_sequence(cfg.fmt, syms)
        if nbits != predicted[si]:
            raise AssertionError(
                f"stream {si}: serializer produced {nbits} bits, device "
                f"model predicted {predicted[si]} -- length model and "
                "serializer have diverged")
        data.append(b)
    return data, outputs, final_state
