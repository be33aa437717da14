"""H.261 encoder: whole frames as tensors on the device.

Port of `p64tpu/core/encoder.py`.  Per frame, for a batch of S independent
streams at once:

    1. full-search ME over all MBs          (kernels.me -> CUDA kernel)
    2. mode decisions                       (control.decisions)
    3. MC prediction + loop filter          (core.predict)
    4. residual -> integer DCT              (kernels.dct)
    5. quantize, CBP/MTYPE/coded masks and the EXACT bit cost of each GOB:
       every GOB at once at a fixed quantizer; under rate control a host
       loop over the GOBs in transmission order, because GOB g's bits set
       GOB g+1's quantizer (optionally with mid-GOB MQUANT segments)
                                            (kernels.quant, entropy.lengths,
                                             control.ratecontrol)
    6. local reconstruction                 (core.reconstruct)

Under rate control a stream whose virtual buffer is over the skip threshold
skips the input frame.  The reference's `lax.cond` is a per-stream select
under `vmap`, and so it is here: the picture is encoded for every stream,
and a skipped stream takes the skip picture's state and outputs instead.

The frame loop is a host `for` loop carrying the state (the reference's
`lax.scan`); the stream axis is explicit (the reference's `vmap`).  The
host then serializes the streams through the C++ engine, one thread per
stream (entropy.encode, utils.fan_map), and asserts that each emitted
exactly the device's bit count.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..spec.constants import (
    DEFAULT_SEARCH_RANGE,
    INTRA_DC_MAX,
    INTRA_DC_MIN,
    LEVEL_CLAMP,
    MBS_PER_GOB,
    Format,
)
from ..spec.tables import MTYPE_BY_NAME
from ..control.decisions import DecisionConfig, decide_modes
from ..control.ratecontrol import (
    STUFF_BITS,
    RateConfig,
    drain_after_frame,
    drain_skipped,
    gob_quant,
    should_skip,
    stuff_count,
)
from ..entropy import lengths
from ..entropy.encode import FrameSymbols, serialize_sequence
from ..kernels.dct import fdct8x8_zz
from ..kernels.me import full_search
from ..kernels.quant import quantize_zz
from ..native import load
from ..utils import device_const, fan_map
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
        buffer=torch.full((streams,), cfg.rate.initial_buffer(),
                          dtype=torch.int32, device=device),
        frame_idx=torch.zeros((streams,), dtype=torch.int32, device=device),
    )


_STATE_DTYPES = dict(ref_y=torch.uint8, ref_cb=torch.uint8,
                     ref_cr=torch.uint8, refresh=torch.int32,
                     buffer=torch.int32, frame_idx=torch.int32)


def state_from_numpy(d: Mapping[str, object],
                     device: torch.device | str) -> State:
    """Encoder state from numpy arrays or tensors laid out as the JAX
    package's `init_state` (ref_y/ref_cb/ref_cr uint8 planes, refresh (nMB,)
    int32, buffer and frame_idx int32 scalars), with or without a leading
    stream axis -- so both packages can resume from the same mid-sequence
    state, and from each other's checkpoints (io.checkpoint)."""
    batched = d["ref_y"].ndim == 3
    out = {}
    for k, dt in _STATE_DTYPES.items():
        v = d[k]
        # numpy: a writable copy for torch
        t = (v.to(device) if isinstance(v, torch.Tensor)
             else torch.as_tensor(np.array(v), device=device))
        if not batched:
            t = t[None]
        out[k] = t.to(dt).contiguous()
    return out


def state_to_numpy(state: State) -> Dict[str, np.ndarray]:
    """The state as numpy arrays with a leading stream axis (slice stream s
    with `{k: v[s] for k, v in ...}` for the JAX package's layout)."""
    return {k: state[k].cpu().numpy() for k in _STATE_DTYPES}


# ---------------------------------------------------------------------------
# one coded picture
# ---------------------------------------------------------------------------


#: base MTYPE -> its MQUANT variant (identity where none exists; only
#: coefficient-bearing types can carry MQUANT, per the H.261 MTYPE table)
_MQ_UPGRADE = np.arange(len(MTYPE_BY_NAME), dtype=np.int32)
for _base, _mq in (("intra", "intra_mquant"), ("inter", "inter_mquant"),
                   ("inter_mc_coef", "inter_mc_mquant"),
                   ("inter_fil_coef", "inter_fil_mquant")):
    _MQ_UPGRADE[_MT[_base]] = _MT[_mq]


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


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 where none), as
    `jnp.argmax` gives it on a bool array."""
    return mask.to(torch.uint8).argmax(dim=-1)


def _gob_mquant(cfg: EncoderConfig, buffer, coefs_g, intra_g, mc_g, fil_g,
                mv_g):
    """One GOB of every stream with mid-GOB MQUANT adaptation
    (`RateConfig.mquant_segments` > 1), as the reference's
    `process_gob_mquant`: segment s re-evaluates the buffer law including
    the modeled bits of earlier segments, and a changed quantizer is
    signaled on the segment's first coefficient-bearing MB through its
    MQUANT MTYPE variant.

    Two priced passes choose the segment quantizers: pass 1 models per-MB
    bits at the GOB quantizer q0, pass 1b at the provisional segment
    quantizers; both add each quantizer change's signaling cost (5-bit
    MQUANT plus the MTYPE length delta) to later segments' projections.

    buffer: (S,) int32; the GOB's tensors carry a leading stream axis.
    Returns (levels, cbp, coded, mtype, q0, quant_mb)."""
    rate = cfg.rate
    nseg = rate.mquant_segments
    dev = buffer.device
    seg_id = (torch.arange(MBS_PER_GOB, device=dev) * nseg) // MBS_PER_GOB
    seg_oh = seg_id[None, :] == torch.arange(nseg, device=dev)[:, None]
    q0 = gob_quant(rate, buffer)                               # (S,)
    mtype_len = device_const(lengths.MTYPE_LEN, dev)
    mq_up = device_const(_MQ_UPGRADE, dev)

    def model_bits(q_mb):
        """Per-MB modeled bits at an (S, 33) quantizer, plus the
        coefficient mask and MTYPEs the signaling cost needs."""
        lv, cb, cd, mt = _quantize_derive(coefs_g, intra_g, mc_g, fil_g,
                                          q_mb[..., None, None])
        return (lengths.gob_payload_bits_per_mb(cd, mt, mv_g, cb, lv),
                cb > 0, mt)

    def seg_quants(model):
        """(S, nseg) segment quantizers from a per-MB bit model, walking
        the segments in order as the real effective-quant chain does."""
        mb_bits, hc, mt = model
        seg_bits = torch.where(seg_oh, mb_bits[:, None, :], 0).sum(
            dim=-1, dtype=torch.int32)                         # (S, nseg)
        segcoef = seg_oh & hc[:, None, :]                      # (S, nseg, 33)
        any_coef = segcoef.any(dim=-1)
        mt_first = torch.gather(mt, 1, _first_true(segcoef)).long()
        sig_cost = torch.where(
            any_coef,
            lengths.MQUANT_BITS + mtype_len[mq_up[mt_first].long()]
            - mtype_len[mt_first], 0)
        qs = []
        eff = q0
        acc = torch.zeros_like(buffer)
        for si in range(nseg):
            q_s = gob_quant(rate, buffer + acc)
            qs.append(q_s)
            if si > 0:
                change = any_coef[:, si] & (q_s != eff)
                eff = torch.where(change, q_s, eff)
                acc = acc + torch.where(change, sig_cost[:, si], 0)
            acc = acc + seg_bits[:, si]
        return torch.stack(qs, dim=1)

    def per_mb(q_seg):
        return torch.where(seg_oh, q_seg[:, :, None], 0).sum(
            dim=1, dtype=torch.int32)                          # (S, 33)

    # pass 1: bits at q0 -> provisional segment quantizers; pass 1b: bits
    # at those -> final segment quantizers
    q_seg1 = seg_quants(model_bits(q0[:, None].expand(-1, MBS_PER_GOB)))
    q_seg = seg_quants(model_bits(per_mb(q_seg1)))
    q_mb = per_mb(q_seg)
    # pass 2: real quantization at the per-MB quantizer
    levels, cbp, coded, base_mtype = _quantize_derive(
        coefs_g, intra_g, mc_g, fil_g, q_mb[..., None, None])
    has_coef = cbp > 0
    # effective-quant chain: only a coefficient-bearing MB can carry MQUANT,
    # so a coefficient-free segment leaves the chain unchanged (its levels
    # are all zero, and any quantizer dequantizes them to zero)
    idxs = torch.arange(MBS_PER_GOB, device=dev)
    eff = q0
    mq_flag = torch.zeros_like(has_coef)
    quant_mb = q_mb
    for si in range(1, nseg):
        in_s = seg_id == si
        segcoef = has_coef & in_s
        change = segcoef.any(dim=-1) & (q_seg[:, si] != eff)
        first = _first_true(segcoef)
        mq_flag = mq_flag | (change[:, None] & (idxs == first[:, None]))
        eff = torch.where(change, q_seg[:, si], eff)
        quant_mb = torch.where(in_s, eff[:, None], quant_mb)
    mtype = torch.where(mq_flag, mq_up[base_mtype.long()], base_mtype)
    return levels, cbp, coded, mtype, q0, quant_mb


def _gob_chain(cfg: EncoderConfig, buffer, coefs_t, intra_t, mc_t, fil_t,
               mv_t):
    """Rate-controlled GOBs in transmission order: GOB g's bits feed GOB
    g+1's quantizer, so this is a host loop over the GOBs (the reference's
    `lax.scan`) carrying each stream's own (S,) buffer.

    Returns (levels, cbp, coded, mtype, gquant, quant, bits), each stacked
    as (S, nGOB, ...)."""
    outs = []
    for g in range(coefs_t.shape[1]):
        xs = (coefs_t[:, g], intra_t[:, g], mc_t[:, g], fil_t[:, g])
        if cfg.rate.mquant_segments > 1:
            levels, cbp, coded, mtype, q, quant_mb = _gob_mquant(
                cfg, buffer, *xs, mv_t[:, g])
        else:
            q = gob_quant(cfg.rate, buffer)
            levels, cbp, coded, mtype = _quantize_derive(
                *xs, q[:, None, None, None])
            quant_mb = q[:, None].expand(-1, MBS_PER_GOB)
        bits = lengths.gob_payload_bits(
            coded, mtype, mv_t[:, g], cbp, levels) + lengths.GOB_HEADER_BITS
        buffer = buffer + bits
        outs.append((levels, cbp, coded, mtype, q, quant_mb, bits))
    return tuple(torch.stack(z, dim=1) for z in zip(*outs))


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

    if cfg.rate.enabled:
        # ---- per-GOB rate-control chain (transmission order) ----
        levels_t, cbp_t, coded_t, mtype_t, gquant, quant_t, gob_bits = (
            _gob_chain(cfg, state["buffer"], to_gob_order(fmt, coefs),
                       to_gob_order(fmt, intra), to_gob_order(fmt, use_mc),
                       to_gob_order(fmt, fil), to_gob_order(fmt, mv)))
    else:
        # ---- every GOB at once, in transmission order (fixed quantizer) --
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


def _skip_picture(cfg: EncoderConfig, state: State, cur_y: torch.Tensor):
    """The state and outputs of a skipped input frame, for every stream
    (the reference's `_skip_picture`): references and refresh counters
    stay, the buffer drains one frame's budget, TR advances."""
    fmt = cfg.fmt
    s, n_mb, dev = cur_y.shape[0], fmt.num_mbs, cur_y.device

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros((s, *shape), dtype=dtype, device=dev)

    new_state = dict(
        ref_y=state["ref_y"], ref_cb=state["ref_cb"], ref_cr=state["ref_cr"],
        refresh=state["refresh"],
        buffer=drain_skipped(cfg.rate, state["buffer"]),
        frame_idx=state["frame_idx"] + 1,
    )
    diff = state["ref_y"].to(torch.int64) - cur_y.to(torch.int64)
    out = dict(
        frame_coded=zeros(dtype=torch.bool),
        tr=state["frame_idx"] & 31,
        gquant=zeros(fmt.num_gobs), quant_mb=zeros(n_mb),
        coded=zeros(n_mb, dtype=torch.bool), mtype=zeros(n_mb),
        mv=zeros(n_mb, 2), cbp=zeros(n_mb),
        levels8=zeros(n_mb, 6, 64, dtype=torch.int8),
        dc_intra=zeros(n_mb, 6, dtype=torch.uint8),
        total_bits=zeros(), n_stuff=zeros(),
        sse_y=(diff * diff).sum(dim=(-2, -1)).to(torch.float32),
    )
    if cfg.emit_recon:
        out.update(recon_y=state["ref_y"], recon_cb=state["ref_cb"],
                   recon_cr=state["ref_cr"])
    return new_state, out


def _per_stream(skip: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """a for the streams where skip is set, b for the others."""
    return torch.where(skip.view(-1, *([1] * (b.dim() - 1))), a, b)


def encode_frame_step(cfg: EncoderConfig, state: State, cur_y: torch.Tensor,
                      cur_cb: torch.Tensor, cur_cr: torch.Tensor):
    """One input frame of every stream; under rate control a stream may
    skip it.  Returns (new_state, out)."""
    coded_state, coded_out = _encode_picture(cfg, state, cur_y, cur_cb,
                                             cur_cr)
    if not cfg.rate.enabled:
        return coded_state, coded_out
    skip = should_skip(cfg.rate, state["buffer"]) & (state["frame_idx"] > 0)
    skip_state, skip_out = _skip_picture(cfg, state, cur_y)
    return ({k: _per_stream(skip, skip_state[k], v)
             for k, v in coded_state.items()},
            {k: _per_stream(skip, skip_out[k], v)
             for k, v in coded_out.items()})


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
        state, out = encode_frame_step(
            cfg, state, fr["y"][:, i].contiguous(),
            fr["cb"][:, i].contiguous(), fr["cr"][:, i].contiguous())
        outs.append(out)
    outputs = {k: torch.stack([o[k] for o in outs], dim=1) for k in outs[0]}
    return state, outputs


# ---------------------------------------------------------------------------
# host-side finalize
# ---------------------------------------------------------------------------


#: the output keys outputs_to_symbols reads
SYMBOL_KEYS = ("frame_coded", "tr", "gquant", "quant_mb", "coded", "mtype",
               "mv", "cbp", "levels8", "dc_intra", "n_stuff")


def outputs_to_host(outputs: Mapping[str, torch.Tensor]
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Optional[torch.cuda.Event]]:
    """Start copying the SYMBOL_KEYS outputs to host memory without
    waiting for the device: returns (host tensors, event).

    On a CUDA device the copies go into pinned buffers with
    non_blocking=True, queued behind the encode on the device's current
    stream, and the event is recorded after them: the host tensors are
    valid once `event.synchronize()` returns.  Waiting on that event alone
    lets a caller queue more work first (tools.batch_encode pipelines
    chunks so), where `tensor.cpu()` would wait for everything queued on
    the stream.  CPU outputs are returned as they are, with no event."""
    dev = outputs["frame_coded"].device
    if dev.type != "cuda":
        return {k: outputs[k] for k in SYMBOL_KEYS}, None
    host = {}
    for k in SYMBOL_KEYS:
        v = outputs[k]
        host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host[k].copy_(v, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(dev))
    return host, event


def outputs_to_symbols(cfg: EncoderConfig,
                       outputs: Mapping[str, object]
                       ) -> List[List[FrameSymbols]]:
    """Stacked (S, T, ...) outputs -> per stream, the FrameSymbols of its
    coded frames, ready for entropy.encode.serialize_sequence.  Outputs
    may be tensors on any device or host arrays (numpy, or the host
    tensors of outputs_to_host once their event has completed)."""
    host = {k: (outputs[k].cpu().numpy() if isinstance(outputs[k],
                                                       torch.Tensor)
                else np.asarray(outputs[k])) for k in SYMBOL_KEYS}
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


def serialize_streams(cfg: EncoderConfig,
                      outputs: Mapping[str, object]
                      ) -> List[Tuple[bytes, int]]:
    """Host finalize of a multi-stream batch: per stream, (bytes, nbits)
    from the native serializer, fanned across threads (the ctypes engine
    releases the GIL), as the reference's `distrib.mesh.serialize_streams`
    does.  Outputs as outputs_to_symbols takes them."""
    load()   # build/load the engine once before fanning out
    return fan_map(lambda syms: serialize_sequence(cfg.fmt, syms),
                   outputs_to_symbols(cfg, outputs))


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
    for si, (b, nbits) in enumerate(serialize_streams(cfg, outputs)):
        if nbits != predicted[si]:
            raise AssertionError(
                f"stream {si}: serializer produced {nbits} bits, device "
                f"model predicted {predicted[si]} -- length model and "
                "serializer have diverged")
        data.append(b)
    return data, outputs, final_state
