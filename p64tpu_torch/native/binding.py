"""ctypes binding for the C++ bit-I/O engine (`csrc/bitio.cpp`).

Port of `p64tpu/native/binding.py` (which imports JAX through
`core.blocks`).  The engine is compiled from the port's copy of the JAX
package's source, `csrc/bitio.cpp`, into `build/native/` by
`kernels._build.build_native`, and beside it, from a source of the port's
own (`csrc/levels_pack.cpp`), the level packer the decode ships its levels
with and the count of picture start codes that sizes the parse's buffers,
by `kernels._build.build_levels_pack`; a missing compiler or a
failed build raises, and nothing falls back to the Python serializer or
parser.
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
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from .. import trace
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


def check_symbols(coded: np.ndarray, mtype: np.ndarray, cbp: np.ndarray,
                  quant_mb: np.ndarray, gquant: np.ndarray) -> None:
    """Raise ValueError where the symbols of the transmitted MBs (`coded`,
    a bool mask over the MB arrays) or the GQUANTs of the transmitted
    pictures are out of range (raise_symbol_errors).  The C++ engines
    trust their inputs: a CBP of 0 or a missing MQUANT value would
    serialize an UNDECODABLE stream that even the length-model ==
    serializer check cannot catch, since both count 0 bits for CBP 0.  The
    Python oracle asserts the same."""
    raise_symbol_errors(
        int((luts.MTYPE_CBP[mtype] & coded & ((cbp < 1) | (cbp > 63))).sum()),
        int((luts.MTYPE_MQUANT[mtype] & coded
             & ((quant_mb < 1) | (quant_mb > 31))).sum()),
        int(((gquant < 1) | (gquant > 31)).sum()))


def raise_symbol_errors(cbp: int, mquant: int, gquant: int,
                        code: int = 0) -> None:
    """Raise ValueError if any count is nonzero, first that of coded
    CBP-bearing MBs with a CBP outside 1..63, then of MQUANT MBs without a
    valid quantizer, of GQUANTs outside 1..31, and of MBs whose MTYPE or
    MVD the code tables do not hold."""
    if cbp:
        raise ValueError(
            f"CBP out of range 1..63 on {cbp} coded CBP-bearing MBs")
    if mquant:
        raise ValueError(
            f"MQUANT MTYPE without a valid 1..31 quant_mb on {mquant} MBs")
    if gquant:
        raise ValueError("GQUANT out of range 1..31")
    if code:
        raise ValueError(f"MTYPE or MVD outside the code tables on {code} "
                         "MBs")


#: the keys pack_levels gives, each a stream's (core.decoder.stack_seqs
#: ships them in place of levels8): per MB the mask of its blocks with a
#: nonzero level, per such block the mask of its nonzero slots, the nonzero
#: levels, and the blocks and levels before each frame
PACKED_KEYS = ("nz_mbs", "nz_blocks", "nz_levels", "nz_offsets")


class NativeBitIO:
    """Wraps libp64bitio.so, and the level packer libp64pack.so; hold one
    instance (tables are retained)."""

    def __init__(self, lib: C.CDLL, pack: C.CDLL) -> None:
        self._lib = lib
        self._pack = pack
        pack.p64_pack_levels.restype = C.c_int64
        pack.p64_pack_levels.argtypes = [_P, C.c_int64, C.c_int32,
                                         C.c_int64] + [_P] * 4
        pack.p64_picture_starts.restype = C.c_int64
        pack.p64_picture_starts.argtypes = [_P, C.c_int64]
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
        check_symbols(coded != 0, mtype, cbp, quant_mb, gq)
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

    # -- levels, packed ----------------------------------------------------

    def pack_levels(self, levels8: np.ndarray) -> Dict[str, np.ndarray]:
        """(T, nMB, 6, 64) int8 levels, each frame's contiguous (a frame
        may be a slice of a larger buffer) -> the PACKED_KEYS arrays
        (`csrc/levels_pack.cpp`):

          nz_mbs     (T, nMB) uint8, bit b set where block b has a nonzero
                     level
          nz_blocks  (B,) uint64, per such block in (frame, MB, block)
                     order, bit j set where slot j is nonzero
          nz_levels  (V,) int8, the nonzero levels in (frame, MB, block,
                     slot) order
          nz_offsets (T + 1, 2) int64, blocks and levels before each frame
                     (the last row: B and V)"""
        if (levels8.dtype != np.int8 or levels8.ndim != 4
                or levels8.shape[2:] != (6, 64)
                or levels8.strides[1:] != (6 * 64, 64, 1)
                or levels8.strides[0] < levels8.shape[1] * 6 * 64):
            raise ValueError(
                f"pack_levels needs (T, nMB, 6, 64) int8 levels with "
                f"contiguous frames; got {levels8.dtype}{levels8.shape} "
                f"strides {levels8.strides}")
        t, m = levels8.shape[:2]
        mbs = np.empty((t, m), np.uint8)
        blocks = np.empty(t * m * 6, np.uint64)
        values = np.empty(t * m * 6 * 64, np.int8)
        offsets = np.empty((t + 1, 2), np.int64)
        self._pack.p64_pack_levels(_ptr(levels8), t, m, levels8.strides[0],
                                   _ptr(mbs), _ptr(blocks), _ptr(values),
                                   _ptr(offsets))
        nb, nv = (int(x) for x in offsets[-1])
        return dict(nz_mbs=mbs, nz_blocks=blocks[:nb].copy(),
                    nz_levels=values[:nv].copy(), nz_offsets=offsets)

    # -- parse -------------------------------------------------------------

    def picture_starts(self, buf: np.ndarray) -> int:
        """The picture start codes in the uint8 stream `buf` at any bit
        position (`csrc/levels_pack.cpp`): at least as many as the pictures
        any parse of it finds."""
        return int(self._pack.p64_picture_starts(_ptr(buf), len(buf)))

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
        """Invoke p64_parse with output buffers sized to the stream.

        The first try holds as many frames as the stream has picture start
        codes (picture_starts), bounded by max_frames: every picture the
        engine parses begins with a start code of its own, so that count is
        enough for any stream, damaged or not.  A try that still overflows
        grows 4x.  The buffers are not zeroed: the engine initializes every
        field of a frame when its picture header parses, and nothing past
        the parsed frames is read.
        While tracing is on, counts the bytes of every try's buffers as
        `p64.parse.alloc_bytes`.  Returns (n, buffers dict); raises
        StreamError on parse errors.  Single owner of the p64_parse
        argument-order contract.
        """
        buf = np.frombuffer(data, np.uint8)
        mf = min(max(self.picture_starts(buf), 1), max_frames)
        while True:
            out = {name: np.empty((mf,) + shape, dt)
                   for name, shape, dt in self._RAW_FIELDS}
            trace.count("p64.parse.alloc_bytes",
                        sum(a.nbytes for a in out.values()))
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
        re-parse, and reconstructs with it, as in the reference), and the
        PACKED_KEYS of levels8 (pack_levels), packed on the calling
        thread, and `damage` (n,) int32, each frame's damage word: bit 15
        where the picture is damaged, bit g where its GOB g is (all zero
        for a strict parse, which raises on damage instead).  Skips the
        per-frame ParsedFrame construction.  Raises StreamError on an empty
        stream and on mixed CIF/QCIF.  resync=True enables start-code
        error recovery.
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
            damage=out["damage"][:n].copy(),
        )
        seq.update(self.pack_levels(seq["levels8"]))
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


#: the (S, T, ...) encoder outputs the batch serializer reads, in its
#: argument order, with the dtype it reads each as (core.encoder's output
#: dtypes; a bool array is read as uint8 in place)
BATCH_ARRAYS = (("frame_coded", np.uint8), ("tr", np.int32),
                ("gquant", np.int32), ("coded", np.uint8),
                ("mtype", np.int32), ("mv", np.int32), ("cbp", np.int32),
                ("levels8", np.int8), ("dc_intra", np.uint8),
                ("quant_mb", np.int32), ("n_stuff", np.int32))
#: bytes each stream's slot holds past its predicted length
SLOT_SLACK = 8


class Batch:
    """A chunk made ready for p64_serialize_batch: its arrays in the
    engine's dtypes, one output buffer with a slot per stream sized from
    the device bit model, and what the engine reports per stream.

      streams:   S
      predicted: (S,) int64, sum over frames of `total_bits`
      offsets:   (S + 1,) int64, stream s's slot is out[offsets[s]:
                 offsets[s + 1]]
      nbits:     (S,) int64, bits written (BatchSerializer.run)
      errors:    (S, 4) int64, symbols out of range, counted as
                 raise_symbol_errors takes them (BatchSerializer.run)
      mquant_mbs: (S,) int64, MBs written with an MQUANT MTYPE
                 (BatchSerializer.run)
    """

    def __init__(self, args: list, arrays: list, predicted: np.ndarray):
        self.streams = len(predicted)
        self.predicted = predicted
        self.offsets = np.zeros(self.streams + 1, np.int64)
        np.cumsum((predicted + 7) // 8 + SLOT_SLACK, out=self.offsets[1:])
        self.out = np.empty(int(self.offsets[-1]), np.uint8)
        self.nbits = np.zeros(self.streams, np.int64)
        self.errors = np.zeros((self.streams, 4), np.int64)
        self.mquant_mbs = np.zeros(self.streams, np.int64)
        self._arrays = arrays          # the arrays `args` points into
        self.args = args
        self.tail = [_ptr(self.out), _ptr(self.offsets), _ptr(self.nbits),
                     _ptr(self.errors), _ptr(self.mquant_mbs)]

    def check(self) -> None:
        """Once every stream has run: raise ValueError for symbols out of
        range (raise_symbol_errors), then AssertionError where a stream's
        bit count differs from its `total_bits`."""
        raise_symbol_errors(*(int(n) for n in self.errors.sum(axis=0)))
        bad = np.flatnonzero(self.nbits != self.predicted)
        if bad.size:
            si = int(bad[0])
            raise AssertionError(
                f"stream {si}: serializer produced {int(self.nbits[si])} "
                f"bits, device model predicted {int(self.predicted[si])} -- "
                "length model and serializer have diverged")


def _engine_array(a: np.ndarray, dtype) -> np.ndarray:
    if a.dtype == np.bool_ and np.dtype(dtype).itemsize == 1:
        a = a.view(np.uint8)
    return np.ascontiguousarray(a, dtype)


class BatchSerializer:
    """Wraps libp64serialize.so (`csrc/serialize_batch.cpp`): a chunk's
    stacked encoder outputs -> each stream's (bytes, nbits), with the bit
    I/O engine's encoder tables.  `prepare` runs once per chunk on the
    calling thread; `run` serializes a range of its streams and may run
    on several threads at once, over disjoint ranges (ctypes releases the
    GIL); `Batch.check` then raises for what the engine counted."""

    def __init__(self, lib: C.CDLL, engine: NativeBitIO) -> None:
        self._lib = lib
        self._engine = engine
        lib.p64_serialize_batch.restype = C.c_int64
        lib.p64_serialize_batch.argtypes = (
            [C.POINTER(_EncTables), C.c_int64, C.c_int32, C.c_int32, _P, _P,
             C.c_int32] + [_P] * len(BATCH_ARRAYS)
            + [C.c_int64, C.c_int64] + [_P] * 5)
        self._perm = {fmt.name: transmission_order(fmt).astype(np.int32)
                      for fmt in (CIF, QCIF)}
        self._gn = {fmt.name: np.ascontiguousarray(fmt.gob_numbers, np.int32)
                    for fmt in (CIF, QCIF)}

    def prepare(self, fmt: Format, outputs: Mapping[str, np.ndarray]
                ) -> Batch:
        """outputs: the BATCH_ARRAYS and `total_bits` as (S, T, ...) host
        arrays of `fmt`.  Raises ValueError on a shape the engine cannot
        walk; sizes each stream's slot from its `total_bits`."""
        arrays = [_engine_array(np.asarray(outputs[k]), dt)
                  for k, dt in BATCH_ARRAYS]
        total_bits = np.asarray(outputs["total_bits"])
        s, t = total_bits.shape
        m = fmt.num_mbs
        want = dict(frame_coded=(), tr=(), n_stuff=(),
                    gquant=(fmt.num_gobs,), coded=(m,), mtype=(m,),
                    cbp=(m,), quant_mb=(m,), mv=(m, 2), levels8=(m, 6, 64),
                    dc_intra=(m, 6))
        for (k, _), a in zip(BATCH_ARRAYS, arrays):
            if a.shape != (s, t, *want[k]):
                raise ValueError(f"{k} of shape {a.shape}: the batch "
                                 f"serializer needs {(s, t, *want[k])}")
        args = [C.byref(self._engine._enc_t), t, m, fmt.num_gobs,
                _ptr(self._gn[fmt.name]), _ptr(self._perm[fmt.name]),
                ptype_value(fmt.is_cif)] + [_ptr(x) for x in arrays]
        return Batch(args, arrays, total_bits.sum(axis=1, dtype=np.int64))

    def run(self, batch: Batch, first: int,
            last: int) -> List[Tuple[bytes, int]]:
        """Serialize streams [first, last) of `batch`: their (bytes,
        nbits), and their bit, error and MQUANT counts into the batch.  A
        stream that outgrew its slot returns the bytes its slot holds; its
        bit count then differs from batch.predicted."""
        if not 0 <= first <= last <= batch.streams:
            raise ValueError(f"streams [{first}, {last}) outside the "
                             f"batch's {batch.streams}")
        self._lib.p64_serialize_batch(*batch.args, first, last, *batch.tail)
        got = []
        for si in range(first, last):
            n = int(batch.nbits[si])
            start = int(batch.offsets[si])
            stop = min(start + (n + 7) // 8, int(batch.offsets[si + 1]))
            got.append((batch.out[start:stop].tobytes(), n))
        return got


_cached: Optional[NativeBitIO] = None
_cached_batch: Optional[BatchSerializer] = None
_load_lock = threading.Lock()


def load() -> NativeBitIO:
    """Build (if needed) and load the native engine and the level packer,
    once per process.

    Raises if the engine cannot be built or loaded.  Thread-safe: the
    parse and serialize fan-outs call it from a thread pool, and two
    unsynchronized first uses would build twice."""
    global _cached
    if _cached is not None:
        return _cached
    with _load_lock:
        if _cached is None:
            _cached = NativeBitIO(
                _build.open_library(_build.build_native()),
                _build.open_library(_build.build_levels_pack()))
        return _cached


def load_batch() -> BatchSerializer:
    """Build (if needed) and load the batch serializer, once per process,
    with the engine of load().  Raises if either cannot be built or
    loaded."""
    global _cached_batch
    if _cached_batch is not None:
        return _cached_batch
    engine = load()
    with _load_lock:
        if _cached_batch is None:
            _cached_batch = BatchSerializer(
                _build.open_library(_build.build_batch_serializer()), engine)
        return _cached_batch
