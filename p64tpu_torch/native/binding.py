"""ctypes binding for the C++ bit-I/O engine (`csrc/bitio.cpp`).

Port of `p64tpu/native/binding.py` (which imports JAX through
`core.blocks`).  The engine is compiled from the port's copy of the JAX
package's source, `csrc/bitio.cpp`, into `build/native/` by
`kernels._build.build_native`; a missing compiler or a failed build
raises, and nothing falls back to the Python serializer or parser.
Contracts mirror the pure-Python implementations exactly
(`entropy.encode.serialize_sequence_py`, `entropy.parse.parse_stream`);
tests assert byte-for-byte equality.

The engine is bound with `ctypes.CDLL`, which releases the GIL for the
duration of each call: that is what lets `utils.fan_map` spread per-stream
serialize and parse calls over threads.
"""

from __future__ import annotations

import ctypes as C
import threading
from typing import List, Optional, Tuple

import numpy as np

from ..spec import luts
from ..spec.constants import CIF, QCIF, Format, ptype_value
from ..core.blocks import transmission_order
from ..entropy.parse import ParsedFrame, StreamError
from ..kernels import _build


class _EncTables(C.Structure):
    _fields_ = [(n, C.c_void_p) for n in (
        "mba_code", "mba_len", "mtype_code", "mtype_len", "mtype_flags",
        "mvd_code", "mvd_len", "cbp_code", "cbp_len",
        "tc_code", "tc_len", "tc_in")]


class _DecTables(C.Structure):
    _fields_ = [(n, C.c_void_p) for n in (
        "mba_sym", "mba_nbits", "mtype_sym", "mtype_nbits", "mtype_flags",
        "mvd_sym", "mvd_nbits", "cbp_sym", "cbp_nbits",
        "tc_kind_first", "tc_run_first", "tc_level_first", "tc_nbits_first",
        "tc_kind_next", "tc_run_next", "tc_level_next", "tc_nbits_next")]


def _ptr(a: np.ndarray) -> C.c_void_p:
    return C.c_void_p(a.ctypes.data)


_P = C.c_void_p
#: p64_parse error codes (bitio.cpp P64_ERR_*) -> the names errors carry
_PARSE_ERRORS = {-1: "no PSC", -2: "bad VLC code", -3: "bad GN",
                 -4: "output overflow", -5: "frame-cap overflow",
                 -6: "forbidden value", -7: "truncated stream",
                 -8: "MV outside picture"}


class NativeBitIO:
    """Wraps libp64bitio.so; hold one instance (tables are retained)."""

    def __init__(self, lib: C.CDLL) -> None:
        self._lib = lib
        lib.p64_pack_symbols.restype = C.c_int64
        lib.p64_pack_symbols.argtypes = [_P, _P, C.c_int64, _P, C.c_int64]
        lib.p64_serialize.restype = C.c_int64
        lib.p64_serialize.argtypes = (
            [C.POINTER(_EncTables), C.c_int64, C.c_int32, C.c_int32, _P, _P,
             C.c_int32] + [_P] * 10 + [C.c_int64])
        lib.p64_parse.restype = C.c_int64
        lib.p64_parse.argtypes = (
            [C.POINTER(_DecTables), _P, C.c_int64, C.c_int64, C.c_int32, _P,
             _P] + [_P] * len(self._RAW_FIELDS) + [C.POINTER(C.c_int64)])

        # encoder tables (keep references alive)
        self._enc_arrays = dict(
            mba_code=luts.MBA_CODE.astype(np.uint32),
            mba_len=luts.MBA_LEN.astype(np.int32),
            mtype_code=luts.MTYPE_CODE.astype(np.uint32),
            mtype_len=luts.MTYPE_LEN.astype(np.int32),
            mtype_flags=np.stack(
                [luts.MTYPE_INTRA, luts.MTYPE_MQUANT, luts.MTYPE_MC,
                 luts.MTYPE_FIL, luts.MTYPE_CBP, luts.MTYPE_TCOEFF],
                axis=1).astype(np.uint8).copy(),
            mvd_code=luts.MVD_CODE.astype(np.uint32),
            mvd_len=luts.MVD_LEN.astype(np.int32),
            cbp_code=luts.CBP_CODE.astype(np.uint32),
            cbp_len=luts.CBP_LEN.astype(np.int32),
            tc_code=luts.TC_CODE.astype(np.uint32).copy(),
            tc_len=luts.TC_LEN.astype(np.int32).copy(),
            tc_in=luts.TC_IN_TABLE.astype(np.uint8).copy(),
        )
        self._enc_t = _EncTables(**{k: _ptr(v) for k, v in
                                    self._enc_arrays.items()})

        kf, rf, lf, nf = luts.TC_LUT_FIRST
        kn, rn, ln, nn = luts.TC_LUT_NEXT
        self._dec_arrays = dict(
            mba_sym=luts.MBA_LUT.symbol.astype(np.int32),
            mba_nbits=luts.MBA_LUT.nbits.astype(np.int32),
            mtype_sym=luts.MTYPE_LUT.symbol.astype(np.int32),
            mtype_nbits=luts.MTYPE_LUT.nbits.astype(np.int32),
            mtype_flags=self._enc_arrays["mtype_flags"],
            mvd_sym=luts.MVD_LUT.symbol.astype(np.int32),
            mvd_nbits=luts.MVD_LUT.nbits.astype(np.int32),
            cbp_sym=luts.CBP_LUT.symbol.astype(np.int32),
            cbp_nbits=luts.CBP_LUT.nbits.astype(np.int32),
            tc_kind_first=kf.astype(np.int8), tc_run_first=rf.astype(np.int8),
            tc_level_first=lf.astype(np.int16),
            tc_nbits_first=nf.astype(np.int8),
            tc_kind_next=kn.astype(np.int8), tc_run_next=rn.astype(np.int8),
            tc_level_next=ln.astype(np.int16),
            tc_nbits_next=nn.astype(np.int8),
        )
        self._dec_t = _DecTables(**{k: _ptr(v) for k, v in
                                    self._dec_arrays.items()})
        self._perm_cif = transmission_order(CIF).astype(np.int32)
        self._perm_qcif = transmission_order(QCIF).astype(np.int32)
        # the C++ engine hardcodes the MBA stuffing pattern in its
        # emitter and greedy-parse fast path ('00000001111' = 0xF/11
        # bits, symbol 34); pin the single source of truth (spec tables)
        # to it so a table change cannot silently diverge the engines
        if ((luts.MBA_STUFFING_CODE, luts.MBA_STUFFING_LEN) != (0xF, 11)
                or luts.MBA_STUFFING_SYMBOL != 34):
            raise RuntimeError(
                "spec MBA stuffing tables diverged from the C++ engine's "
                "hardcoded pattern -- update bitio.cpp (kStuff4, emitter)")

    # -- pack --------------------------------------------------------------

    def pack_symbols(self, codes: np.ndarray,
                     lens: np.ndarray) -> Tuple[bytes, int]:
        codes = np.ascontiguousarray(codes, dtype=np.uint64)
        lens = np.ascontiguousarray(lens, dtype=np.int64)
        if len(lens) and (lens.max() > 64 or lens.min() < 0):
            # C++ bw_put shifts a uint64 by the length -- >64 would be UB
            # (the Python oracle asserts the same contract)
            raise ValueError("symbol lengths must be 0..64")
        cap = int(lens.sum()) // 8 + 16
        out = np.zeros(cap, np.uint8)
        n = self._lib.p64_pack_symbols(_ptr(codes), _ptr(lens), len(codes),
                                       _ptr(out), cap)
        if n < 0:
            raise RuntimeError("pack overflow")
        return out[: (n + 7) // 8].tobytes(), int(n)

    # -- serialize ---------------------------------------------------------

    def serialize(self, fmt: Format, frames: List) -> Tuple[bytes, int]:
        """frames: list of entropy.encode.FrameSymbols (coded frames)."""
        if not frames:
            return b"", 0
        n = len(frames)
        n_mb, n_gob = fmt.num_mbs, fmt.num_gobs
        tr = np.ascontiguousarray([f.tr for f in frames], np.int32)
        gq = np.ascontiguousarray(np.stack([f.gquant for f in frames]),
                                  np.int32)
        coded = np.ascontiguousarray(np.stack([f.coded for f in frames]),
                                     np.uint8)
        mtype = np.ascontiguousarray(np.stack([f.mtype for f in frames]),
                                     np.int32)
        mv = np.ascontiguousarray(np.stack([f.mv for f in frames]), np.int32)
        cbp = np.ascontiguousarray(np.stack([f.cbp for f in frames]),
                                   np.int32)
        levels = np.ascontiguousarray(np.stack([f.levels for f in frames]),
                                      np.int16)
        quant_mb = np.ascontiguousarray(np.stack(
            [f.quant_mb if f.quant_mb is not None
             else np.zeros(n_mb, np.int32) for f in frames]), np.int32)
        n_stuff = np.ascontiguousarray([f.n_stuff for f in frames], np.int32)
        # validity guards mirroring the Python oracle (the C++ engine
        # trusts its inputs; a CBP of 0 or a missing MQUANT value would
        # otherwise serialize an UNDECODABLE stream that even the
        # length-model == serializer assert cannot catch, since both
        # count 0 bits for CBP 0)
        cmask = coded != 0
        bad_cbp = (luts.MTYPE_CBP[mtype] & cmask
                   & ((cbp < 1) | (cbp > 63)))
        if bad_cbp.any():
            raise ValueError(
                f"CBP out of range 1..63 on {int(bad_cbp.sum())} coded "
                f"CBP-bearing MBs")
        bad_mq = (luts.MTYPE_MQUANT[mtype] & cmask
                  & ((quant_mb < 1) | (quant_mb > 31)))
        if bad_mq.any():
            raise ValueError(
                f"MQUANT MTYPE without a valid 1..31 quant_mb on "
                f"{int(bad_mq.sum())} MBs")
        if ((gq < 1) | (gq > 31)).any():
            raise ValueError("GQUANT out of range 1..31")
        perm = transmission_order(fmt).astype(np.int32)
        gn = np.ascontiguousarray(fmt.gob_numbers, np.int32)
        # capacity: worst case ~ every coefficient escapes; generous bound
        cap = (int(n) * (64 + n_gob * 40 +
                         n_mb * (40 + 6 * (64 * 20 + 10))) // 8
               + int(n_stuff.sum()) * 11 // 8 + 1024)
        # p64_serialize memsets the whole buffer itself -- empty, not zeros
        out = np.empty(cap, np.uint8)
        bits = self._lib.p64_serialize(
            C.byref(self._enc_t), n, n_mb, n_gob, _ptr(gn), _ptr(perm),
            ptype_value(fmt.is_cif), _ptr(tr), _ptr(gq), _ptr(coded),
            _ptr(mtype), _ptr(mv), _ptr(cbp), _ptr(levels), _ptr(quant_mb),
            _ptr(n_stuff), _ptr(out), cap)
        if bits < 0:
            raise RuntimeError("serialize overflow")
        return out[: (bits + 7) // 8].tobytes(), int(bits)

    # -- parse -------------------------------------------------------------

    _RAW_FIELDS = (("fmt", (), np.int32), ("tr", (), np.int32),
                   ("gq", (12,), np.int32), ("coded", (396,), np.uint8),
                   ("intra", (396,), np.uint8), ("mc", (396,), np.uint8),
                   ("fil", (396,), np.uint8), ("quant", (396,), np.int32),
                   ("mv", (396, 2), np.int32), ("cbp", (396,), np.int32),
                   ("levels8", (396, 6, 64), np.int8),
                   ("dc", (396, 6), np.uint8),
                   ("damage", (), np.int32))

    def _raw_parse(self, data: bytes, max_frames: int,
                   resync: bool = False):
        """Invoke p64_parse with adaptively-grown output buffers.

        Starts at min(64, max_frames) frames and grows 4x on overflow --
        eagerly allocating 4096-frame buffers costs more than the parse of
        a short stream.  Returns (n, buffers dict); raises StreamError on
        parse errors.  Single owner of the p64_parse argument-order
        contract.
        """
        buf = np.frombuffer(data, np.uint8)
        mf = min(64, max_frames)
        while True:
            out = {name: np.zeros((mf,) + shape, dt)
                   for name, shape, dt in self._RAW_FIELDS}
            errpos = C.c_int64(0)
            n = self._lib.p64_parse(
                C.byref(self._dec_t), _ptr(buf), len(data), mf,
                1 if resync else 0, _ptr(self._perm_cif),
                _ptr(self._perm_qcif),
                *[_ptr(out[name]) for name, _, _ in self._RAW_FIELDS],
                C.byref(errpos))
            if n == -5 and mf < max_frames:     # P64_ERR_MAXFRAMES
                mf = min(mf * 4, max_frames)
                continue
            break
        if n < 0:
            raise StreamError(
                f"{_PARSE_ERRORS.get(n, 'parse error')} at bit "
                f"{errpos.value} (native code {n})")
        return n, out

    def parse_tensors(self, data: bytes, max_frames: int = 65536,
                      resync: bool = False):
        """Parse a single-format stream straight into stacked arrays.

        Returns (fmt, tr (n,), seq) where seq has the (n, ...) arrays the
        batched device reconstruction consumes (levels8/dc/quant/intra/mv/
        fil, with intra/fil already masked by coded; mv is NOT masked --
        an uncoded MB of a damaged GOB can keep the MV of a failed
        re-parse, and reconstructs with it, as in the reference).  Skips
        the per-frame ParsedFrame construction.  Raises StreamError on an
        empty stream and on mixed CIF/QCIF.  resync=True enables start-code
        error recovery (damage flags are not surfaced on this path).
        """
        n, out = self._raw_parse(data, max_frames, resync=resync)
        if n == 0:
            raise StreamError("empty stream")
        if not (out["fmt"][:n] == out["fmt"][0]).all():
            raise StreamError("mixed picture formats in one sequence")
        fmt = CIF if out["fmt"][0] else QCIF
        m = fmt.num_mbs
        coded = out["coded"][:n, :m] != 0
        seq = dict(
            # levels stay int8 VIEWS straight out of the C++ engine (plus
            # the uint8 intra-DC sidecar); the device reassembles them
            # (core.decoder).  No eager widening copy here: densifying a
            # mostly-zero 32-frame CIF stream costs several times the parse.
            levels8=out["levels8"][:n, :m],
            dc=out["dc"][:n, :m],
            quant=out["quant"][:n, :m],
            intra=(out["intra"][:n, :m] != 0) & coded,
            mv=out["mv"][:n, :m],
            fil=(out["fil"][:n, :m] != 0) & coded,
        )
        return fmt, out["tr"][:n].copy(), seq

    def parse(self, data: bytes, max_frames: int = 65536,
              copy: bool = False, resync: bool = False) -> List[ParsedFrame]:
        """Returns list of entropy.parse.ParsedFrame (same contract as the
        Python parser).  resync=True enables start-code error recovery
        (same contract as parse_stream(strict=False): damaged GOBs keep
        their already-decoded MBs and are flagged in damaged/gob_damaged;
        corrupt input never raises).

        By default gquant/quant/mv/cbp are VIEWS into per-call output
        buffers (at most 4x the parsed frame count), so retaining any one
        frame keeps the whole call's buffers alive; copy=True gives
        independent per-frame arrays.  `levels` views an int16 array
        made per call, since the ParsedFrame contract needs the engine's
        int8 levels and DC sidecar reassembled."""
        n, out = self._raw_parse(data, max_frames, resync=resync)
        c = (lambda a: a.copy()) if copy else (lambda a: a)
        (out_fmt, out_tr, out_gq, out_coded, out_intra, out_mc, out_fil,
         out_quant, out_mv, out_cbp, out_levels8, out_dc, out_damage) = (
            out[name] for name, _, _ in self._RAW_FIELDS)
        # reassemble the int16 levels (DC in slot 0): one widening astype,
        # then scatter only the DC slots (dc > 0 exactly marks parsed intra
        # blocks, range 1..254)
        out_levels = out_levels8[:n].astype(np.int16)
        dcn = out_dc[:n]
        dmask = dcn > 0
        out_levels[..., 0][dmask] = dcn[dmask]
        frames = []
        for f in range(n):
            fmt = CIF if out_fmt[f] else QCIF
            m = fmt.num_mbs
            dmg = int(out_damage[f])
            frames.append(ParsedFrame(
                tr=int(out_tr[f]), fmt=fmt,
                gquant=c(out_gq[f, :fmt.num_gobs]),
                coded=out_coded[f, :m].astype(bool),
                intra=out_intra[f, :m].astype(bool),
                mc=out_mc[f, :m].astype(bool),
                fil=out_fil[f, :m].astype(bool),
                quant=c(out_quant[f, :m]),
                mv=c(out_mv[f, :m]),
                cbp=c(out_cbp[f, :m]),
                levels=c(out_levels[f, :m]),
                damaged=bool(dmg >> 15 & 1),
                gob_damaged=(
                    (dmg >> np.arange(fmt.num_gobs)) & 1).astype(bool)))
        return frames


_cached: Optional[NativeBitIO] = None
_load_lock = threading.Lock()


def load() -> NativeBitIO:
    """Build (if needed) and load the native engine, once per process.

    Raises if the engine cannot be built or loaded.  Thread-safe: the
    parse and serialize fan-outs call it from a thread pool, and two
    unsynchronized first uses would build twice."""
    global _cached
    if _cached is not None:
        return _cached
    with _load_lock:
        if _cached is None:
            _cached = NativeBitIO(_build.open_library(_build.build_native()))
        return _cached
