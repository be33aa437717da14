"""Wrapper of the rate-control GOB chain's kernels (`csrc/rate_chain.cu`).

`rate_chain_cuda` takes what `core.encoder._gob_chain` takes -- the buffer
and one picture's transmission-ordered coefficients, decisions and MVs of
every stream -- and returns the same seven tensors, bit for bit, from three
launches: price (every MB at every quantizer), walk (one warp per stream
through the GOBs and MQUANT segments, on the price table) and emit (the
levels at each MB's quantizer).  See the source for the design and its
bound.  It takes CUDA tensors only; `core.encoder.gob_chain` sends CPU
tensors to the plain chain.

The VLC and MTYPE tables go to the kernels as one int32 device tensor built
from `spec.luts` (`chain_tables`), laid out as TABLE_LAYOUT says; the
source's constants name the same offsets.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from ..control.ratecontrol import RateConfig
from ..entropy import lengths
from ..spec import luts
from ..spec.constants import MBS_PER_GOB
from ..spec.tables import MTYPE_BY_NAME
from ..utils import device_const
from . import _build

#: kernel launches since the count was last reset: three a chain, and each
#: replay of a captured graph (core.graphs) the launches its capture recorded
LAUNCHES = 0
#: (stream, GOB) pairs the walk carried, counted as LAUNCHES is
GOBS = 0

#: launches of one chain: price, walk, emit
KERNELS = ("price", "walk", "emit")
#: quantizers the price table holds (QUANT 1..31)
QUANTS = 31
#: threads of a price CTA, and CTAs of the price and emit grids per SM
PRICE_THREADS, EMIT_THREADS, CTAS_PER_SM = 192, 256, 8

#: MTYPE flag bits of the table's per-MTYPE flag word
FLAG_MC, FLAG_CBP, FLAG_TCOEFF, FLAG_MQUANT = 1, 2, 4, 8
#: the MTYPEs the decisions and the coefficient mask choose among, in the
#: order the walk indexes them
MT_CODES = ("intra", "inter", "inter_mc", "inter_mc_coef", "inter_fil",
            "inter_fil_coef")


def _parts():
    flags = (luts.MTYPE_MC.astype(np.int32) * FLAG_MC
             + luts.MTYPE_CBP.astype(np.int32) * FLAG_CBP
             + luts.MTYPE_TCOEFF.astype(np.int32) * FLAG_TCOEFF
             + luts.MTYPE_MQUANT.astype(np.int32) * FLAG_MQUANT)
    return (
        ("tc_len", luts.TC_LEN.reshape(-1)),
        ("mba_len", luts.MBA_LEN),
        ("mtype_len", lengths.MTYPE_LEN),
        ("mvd_len", luts.MVD_LEN),
        ("cbp_len", luts.CBP_LEN),
        ("mtype_flags", flags),
        ("mq_up", luts.MQ_UPGRADE),
        ("mt_code", np.asarray([MTYPE_BY_NAME[n] for n in MT_CODES])),
        ("scalar", np.asarray([luts.EOB_LEN, luts.FIRST01_SAVING,
                               lengths.MQUANT_BITS,
                               lengths.GOB_HEADER_BITS])),
    )


def _layout():
    out, at = {}, 0
    for name, part in _parts():
        out[name] = at
        at += part.size
    out["size"] = at
    return out


#: offset of each table in the tensor, and its size (csrc/rate_chain.cu
#: kTcLen ... kTableSize)
TABLE_LAYOUT = _layout()
#: the tables as one int32 array
CHAIN_TABLES = np.concatenate(
    [np.asarray(p, np.int32).reshape(-1) for _, p in _parts()])


def chain_tables(device: torch.device) -> torch.Tensor:
    """The kernels' tables on `device`, uploaded once per device."""
    return device_const(CHAIN_TABLES, device)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build and load the chain's library and declare its C signatures,
    once per process."""
    lib = _build.load("rate_chain")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.p64_rate_price.argtypes = [ptr] * 3 + [i32] * 2 + [ptr] * 2
    lib.p64_rate_walk.argtypes = [ptr] * 7 + [i32] * 5 + [ptr] * 8
    lib.p64_rate_emit.argtypes = [ptr] * 4 + [i64, i32] + [ptr] * 2
    for fn in (lib.p64_rate_price, lib.p64_rate_walk, lib.p64_rate_emit):
        fn.restype = i32
    lib.p64_cuda_error_string.argtypes = [i32]
    lib.p64_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(kernel: str, device: torch.device, *args) -> None:
    """Call p64_rate_<kernel>(*args, stream) on the device's current stream;
    raise RuntimeError on a non-zero CUDA error code."""
    global LAUNCHES
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, "p64_rate_" + kernel)(*args, stream)
    if rc != 0:
        msg = lib.p64_cuda_error_string(rc).decode()
        raise RuntimeError(f"rate chain {kernel} kernel launch failed: CUDA "
                           f"error {rc} ({msg})")
    LAUNCHES += 1


def check_inputs(rate: RateConfig, buffer: torch.Tensor,
                 coefs_t: torch.Tensor, intra_t: torch.Tensor,
                 mc_t: torch.Tensor, fil_t: torch.Tensor,
                 mv_t: torch.Tensor) -> Tuple[int, int]:
    """Raise ValueError unless the chain's inputs are what the kernels take:
    a rate-controlled config; buffer (S,) int32; coefs_t (S, nGOB, 33, 6,
    64) int32, 16-byte aligned; intra_t, mc_t, fil_t (S, nGOB, 33) bool;
    mv_t (S, nGOB, 33, 2) int32; all contiguous, on one CUDA device.
    Returns (S, nGOB)."""
    if not rate.enabled:
        raise ValueError("rate_chain_cuda: the config has no rate control "
                         f"(bit_rate {rate.bit_rate})")
    if rate.mquant_segments < 1:
        raise ValueError("rate_chain_cuda: mquant_segments must be >= 1; "
                         f"got {rate.mquant_segments}")
    if buffer.dim() != 1 or coefs_t.dim() != 5:
        raise ValueError("rate_chain_cuda: buffer must be (S,) and coefs_t "
                         f"(S, nGOB, 33, 6, 64); got {tuple(buffer.shape)} "
                         f"and {tuple(coefs_t.shape)}")
    s, ngob = coefs_t.shape[:2]
    want = {"buffer": ((s,), torch.int32),
            "coefs_t": ((s, ngob, MBS_PER_GOB, 6, 64), torch.int32),
            "intra_t": ((s, ngob, MBS_PER_GOB), torch.bool),
            "mc_t": ((s, ngob, MBS_PER_GOB), torch.bool),
            "fil_t": ((s, ngob, MBS_PER_GOB), torch.bool),
            "mv_t": ((s, ngob, MBS_PER_GOB, 2), torch.int32)}
    got = dict(buffer=buffer, coefs_t=coefs_t, intra_t=intra_t, mc_t=mc_t,
               fil_t=fil_t, mv_t=mv_t)
    for name, (shape, dtype) in want.items():
        t = got[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"rate_chain_cuda: {name} is {t.dtype}"
                             f"{tuple(t.shape)}, needs {dtype}{shape}")
        if not t.is_contiguous():
            raise ValueError(f"rate_chain_cuda: {name} must be contiguous")
    if not 1 <= s <= 2**31 - 1 or ngob < 1:
        raise ValueError(f"rate_chain_cuda: unsupported shape "
                         f"{tuple(coefs_t.shape)}")
    for name, t in got.items():
        if not t.is_cuda:
            raise ValueError(f"rate_chain_cuda: {name} is on {t.device}, "
                             "not a CUDA device")
        if t.device != coefs_t.device:
            raise ValueError(f"rate_chain_cuda: {name} is on {t.device}, "
                             f"coefs_t on {coefs_t.device}")
    if coefs_t.data_ptr() % 16:
        raise ValueError("rate_chain_cuda: coefs_t must be 16-byte aligned")
    return s, ngob


def price(coefs_t: torch.Tensor, intra_t: torch.Tensor) -> torch.Tensor:
    """The price table: (S, nGOB, 33, 31) int32, at [..., q - 1] the MB's
    coefficient bits at QUANT q (EOB and the intra DC FLC included) shifted
    left by 6, or'ed with its CBP at q."""
    dev = coefs_t.device
    n_mbs = coefs_t.numel() // (6 * 64)
    out = torch.empty((*coefs_t.shape[:3], QUANTS), dtype=torch.int32,
                      device=dev)
    grid = min(n_mbs, _sms(dev.index or 0) * CTAS_PER_SM)
    _launch("price", dev, coefs_t.data_ptr(), intra_t.data_ptr(),
            chain_tables(dev).data_ptr(), n_mbs, grid, out.data_ptr())
    return out


def walk(rate: RateConfig, buffer: torch.Tensor, table: torch.Tensor,
         intra_t: torch.Tensor, mc_t: torch.Tensor, fil_t: torch.Tensor,
         mv_t: torch.Tensor):
    """The GOBs of every stream in transmission order on the price table.
    Returns (cbp, coded, mtype, gquant, quant, bits) as `_gob_chain` does,
    and qlev (S, nGOB, 33) int32, the QUANT each MB's levels take."""
    global GOBS
    dev = buffer.device
    s, ngob = table.shape[:2]
    mbs = (s, ngob, MBS_PER_GOB)

    def empty(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    cbp, coded, mtype = empty(mbs), empty(mbs, torch.bool), empty(mbs)
    gquant, quant, bits, qlev = empty((s, ngob)), empty(mbs), \
        empty((s, ngob)), empty(mbs)
    _launch("walk", dev, table.data_ptr(), intra_t.data_ptr(),
            mc_t.data_ptr(), fil_t.data_ptr(), mv_t.data_ptr(),
            buffer.data_ptr(), chain_tables(dev).data_ptr(), s, ngob,
            rate.mquant_segments, rate.qdfact, rate.qoffs, cbp.data_ptr(),
            coded.data_ptr(), mtype.data_ptr(), gquant.data_ptr(),
            quant.data_ptr(), bits.data_ptr(), qlev.data_ptr())
    GOBS += s * ngob
    return cbp, coded, mtype, gquant, quant, bits, qlev


def emit(coefs_t: torch.Tensor, intra_t: torch.Tensor, coded: torch.Tensor,
         qlev: torch.Tensor) -> torch.Tensor:
    """(S, nGOB, 33, 6, 64) int32 levels of every block at its MB's QUANT
    `qlev`, zero on MBs that are not coded."""
    dev = coefs_t.device
    levels = torch.empty_like(coefs_t)
    quads = coefs_t.numel() // 4
    grid = min(-(-quads // EMIT_THREADS), _sms(dev.index or 0) * CTAS_PER_SM)
    _launch("emit", dev, coefs_t.data_ptr(), intra_t.data_ptr(),
            coded.data_ptr(), qlev.data_ptr(), quads, grid,
            levels.data_ptr())
    return levels


def rate_chain_cuda(rate: RateConfig, buffer: torch.Tensor,
                    coefs_t: torch.Tensor, intra_t: torch.Tensor,
                    mc_t: torch.Tensor, fil_t: torch.Tensor,
                    mv_t: torch.Tensor):
    """The rate-controlled GOB chain on the card: `core.encoder._gob_chain`'s
    arguments (with the config's RateConfig) and its outputs (levels, cbp,
    coded, mtype, gquant, quant, bits), each (S, nGOB, ...), in its dtypes.
    Raises ValueError on inputs the kernels do not take (check_inputs) and
    RuntimeError on a launch that fails."""
    check_inputs(rate, buffer, coefs_t, intra_t, mc_t, fil_t, mv_t)
    table = price(coefs_t, intra_t)
    cbp, coded, mtype, gquant, quant, bits, qlev = walk(
        rate, buffer, table, intra_t, mc_t, fil_t, mv_t)
    levels = emit(coefs_t, intra_t, coded, qlev)
    return levels, cbp, coded, mtype, gquant, quant, bits
