"""Hardware parity gate of the port: proves the CUDA paths are bit-exact.

Counterpart of `tools/tpu_parity.py`.  A CPU-green suite once shipped a
device path that was wrong on the device, so this gate runs on the card
and asserts:

  1. SAD-map exactness: every SAD formulation of the port -- the plain
     `me.sad_map`, the four plain variants of `me_variants` and, on CUDA,
     the five hand-written kernels -- equals an int64 numpy oracle on
     random and periodic (near-tie) planes at search 15, with every
     out-of-picture offset at 1<<30; and `me.full_search` picks the
     oracle's first minimum in dy-major order.
  2. Integer DCT/IDCT exactness: `fdct8x8` / `idct8x8` on the device equal
     an int64 numpy re-computation.
  3. End-to-end bitstream equality: the adversarial sequences (fixed q and
     192 kbit/s rate control at QCIF) and CIF (fixed q and 1.024 Mbit/s
     rate control with 3 MQUANT segments) encode to byte-identical streams
     on the card and on the CPU, in this process.

Usage (needs a CUDA card; exits non-zero without one):

  python -m p64tpu_torch.tools.parity

Prints PARITY PASS and exits 0 only if every check passed.  The check
functions take a device, so the tests run them on the CPU.
"""

from __future__ import annotations

import hashlib
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

SEARCH = 15


def log(*a) -> None:
    print("[parity]", *a, flush=True)


# ---------------------------------------------------------------------------
# oracles and content
# ---------------------------------------------------------------------------


def sad_oracle(cur: np.ndarray, ref: np.ndarray, search: int) -> np.ndarray:
    """int64 numpy SAD map (S, (2s+1)^2, nMB) of (S, H, W) planes, offsets
    in dy-major order, out-of-picture offsets 1<<30."""
    s, h, w = cur.shape
    r, c = h // 16, w // 16
    cur = cur.astype(np.int64)
    pad = np.pad(ref.astype(np.int64), ((0, 0), (search, search),
                                        (search, search)))
    side = 2 * search + 1
    out = np.empty((s, side * side, r * c), np.int64)
    y0 = (np.arange(r * c) // c) * 16
    x0 = (np.arange(r * c) % c) * 16
    for i, (dy, dx) in enumerate((dy, dx) for dy in range(-search, search + 1)
                                 for dx in range(-search, search + 1)):
        win = pad[:, search + dy:search + dy + h, search + dx:search + dx + w]
        box = np.abs(cur - win).reshape(s, r, 16, c, 16).sum(axis=(2, 4))
        valid = ((y0 + dy >= 0) & (y0 + dy + 16 <= h) & (x0 + dx >= 0)
                 & (x0 + dx + 16 <= w))
        out[:, i] = np.where(valid, box.reshape(s, -1), 1 << 30)
    return out


def parity_planes() -> Dict[str, tuple]:
    """The gate's QCIF planes, two streams each, as `tools/tpu_parity.py`
    builds them: random bytes, and a periodic texture (period 8) against
    itself shifted by half a period (stream 0) and by 5 pixels (stream 1,
    an odd dx) -- exact SAD ties everywhere."""
    rng = np.random.default_rng(7)
    h, w = 144, 176
    per = (((np.mgrid[0:h, 0:w][1] % 8 < 4)) * 200 + 20).astype(np.uint8)
    return {
        "random": (rng.integers(0, 256, (2, h, w), np.uint8),
                   rng.integers(0, 256, (2, h, w), np.uint8)),
        "periodic": (np.stack([per, per]),
                     np.stack([np.roll(per, 4, axis=1),
                               np.roll(per, 5, axis=1)])),
    }


def _formulations(device: torch.device):
    """name -> fn(cur, ref, search) returning the (S, side^2, nMB) map, for
    every SAD formulation the port has on this device."""
    from ..kernels import me, me_cuda, me_variants

    out = {"map": me.sad_map}
    for name, (_, plain) in me_variants.VARIANTS.items():
        out[name + "_plain"] = plain
    if device.type == "cuda":
        out["sad_search_kernel_map"] = (
            lambda c, r, s: me_cuda.sad_search_cuda(c, r, s, with_map=True)[3])
        for name, (dispatch, _) in me_variants.VARIANTS.items():
            out[name + "_kernel"] = dispatch
    return out


def check_sad(device: str | torch.device) -> bool:
    from ..kernels import me

    device = torch.device(device)
    ok = True
    for pname, (cur_np, ref_np) in parity_planes().items():
        gold = sad_oracle(cur_np, ref_np, SEARCH)
        valid = gold < (1 << 30)
        cur = torch.as_tensor(cur_np, device=device)
        ref = torch.as_tensor(ref_np, device=device)
        for vname, fn in _formulations(device).items():
            got = fn(cur, ref, SEARCH)
            if got.dtype != torch.int32 or tuple(got.shape) != gold.shape:
                log(f"FAIL sad[{pname}/{vname}]: {got.dtype} "
                    f"{tuple(got.shape)} != int32 {gold.shape}")
                ok = False
                continue
            got = got.cpu().numpy().astype(np.int64)
            bad = int(((got != gold) & valid).sum())
            bad_invalid = int(((got != (1 << 30)) & ~valid).sum())
            if bad or bad_invalid:
                log(f"FAIL sad[{pname}/{vname}]: {bad} wrong entries, "
                    f"{bad_invalid} invalid offsets not 1<<30")
                ok = False
            else:
                log(f"ok   sad[{pname}/{vname}]: exact")
        # the encoder's dispatch end to end: MVs + SADs under the tie-break
        # contract (the FIRST minimum in dy-major scan order wins)
        mv, best, sad0 = (x.cpu().numpy() for x in
                          me.full_search(cur, ref, SEARCH))
        bi = gold.argmin(axis=1)                                 # (S, nMB)
        offs = me.offset_table(SEARCH)
        want_mv = np.stack([offs[bi][..., 1], offs[bi][..., 0]], axis=-1)
        if not (np.array_equal(mv, want_mv)
                and np.array_equal(best, gold.min(axis=1))
                and np.array_equal(sad0,
                                   gold[:, me.zero_offset_index(SEARCH)])):
            log(f"FAIL full_search[{pname}]: MV/SAD mismatch "
                f"({int((mv != want_mv).any(axis=-1).sum())} MBs)")
            ok = False
        else:
            log(f"ok   full_search[{pname}]: MVs + SADs exact")
    return ok


def check_dct(device: str | torch.device) -> bool:
    from ..kernels import dct

    rng = np.random.default_rng(11)
    x = rng.integers(-255, 256, (2048, 8, 8)).astype(np.int64)
    mi = dct.MI.astype(np.int64)
    mi2 = dct.MI2.astype(np.int64)
    s = np.einsum("nx,ux->nu", x.reshape(-1, 64), mi2)
    want_f = ((s + (1 << (dct.FWD_SCALE_BITS - 1))) >> dct.FWD_SCALE_BITS
              ).reshape(-1, 8, 8)
    got_f = dct.fdct8x8(torch.as_tensor(x, dtype=torch.int32,
                                        device=device)).cpu().numpy()
    c = rng.integers(-2048, 2048, (2048, 8, 8)).astype(np.int64)
    t = (np.einsum("ux,nuv->nxv", mi, c) + (1 << (dct.INV_SHIFT1 - 1))
         ) >> dct.INV_SHIFT1
    want_i = (np.einsum("nxv,vy->nxy", t, mi) + (1 << (dct.INV_SHIFT2 - 1))
              ) >> dct.INV_SHIFT2
    got_i = dct.idct8x8(torch.as_tensor(c, dtype=torch.int32,
                                        device=device)).cpu().numpy()
    ok = np.array_equal(got_f, want_f) and np.array_equal(got_i, want_i)
    log("ok   dct: fdct/idct exact on the device" if ok
        else "FAIL dct: device integer DCT != int64 oracle")
    return ok


# ---------------------------------------------------------------------------
# end-to-end encodes
# ---------------------------------------------------------------------------


def encode_all(device: str | torch.device) -> bytes:
    """The gate's encodes on `device`, as one blob in the layout of
    `tools/tpu_parity.encode_all`: for each part `name:tag:len\\n` and the
    stream's bytes.  The four adversarial QCIF sequences (sorted by name)
    at q10 and at 192 kbit/s, then CIF (3 frames of config3's content) at
    q10 and at 1.024 Mbit/s with 3 MQUANT segments.  The four sequences of
    one setting are encoded as four streams of one batch."""
    from ..spec.constants import CIF, QCIF
    from ..tools import golden_content as gc

    from ..control.ratecontrol import RateConfig
    from ..core.encoder import EncoderConfig, encode_to_bytes

    seqs = sorted(gc.adversarial_sequences().items())
    per_seq = [gc.luma_to_frames(y) for _, y in seqs]
    batch = {k: np.stack([f[k] for f in per_seq]) for k in ("y", "cb", "cr")}
    qcif = {}
    for tag, rate in (("q10", RateConfig(fixed_quant=10)),
                      ("rc", RateConfig(bit_rate=192_000, frame_rate=30))):
        qcif[tag], _, _ = encode_to_bytes(EncoderConfig(fmt=QCIF, rate=rate),
                                          batch, device=device)
    blob = bytearray()
    for i, (name, _) in enumerate(seqs):
        for tag in ("q10", "rc"):
            data = qcif[tag][i]
            blob += f"{name}:{tag}:{len(data)}\n".encode() + data
    cif = {k: v[None, :3] for k, v in gc.config3_cif_rc(3).items()}
    for tag, rate in (("q10", RateConfig(fixed_quant=10)),
                      ("rc", RateConfig(bit_rate=1_024_000, frame_rate=30,
                                        mquant_segments=3))):
        data, _, _ = encode_to_bytes(EncoderConfig(fmt=CIF, rate=rate), cif,
                                     device=device)
        blob += f"cif:{tag}:{len(data[0])}\n".encode() + data[0]
    return bytes(blob)


def split_blob(blob: bytes) -> Dict[str, bytes]:
    """`name:tag` -> stream bytes of an `encode_all` blob."""
    parts, at = {}, 0
    while at < len(blob):
        nl = blob.index(b"\n", at)
        name, tag, n = blob[at:nl].decode().split(":")
        parts[f"{name}:{tag}"] = blob[nl + 1:nl + 1 + int(n)]
        at = nl + 1 + int(n)
    return parts


def check_encode_cross_device() -> bool:
    """Encode the gate's content on the card and on the CPU; compare."""
    a = encode_all("cuda")
    b = encode_all("cpu")
    ha, hb = hashlib.sha256(a).hexdigest(), hashlib.sha256(b).hexdigest()
    if a != b:
        pa, pb = split_blob(a), split_blob(b)
        diff = [k for k in pb if pa.get(k) != pb[k]]
        log(f"FAIL encode: bitstreams differ (cuda {ha[:16]} vs cpu "
            f"{hb[:16]}, lens {len(a)} vs {len(b)}; parts {diff})")
        return False
    log(f"ok   encode: {len(a)} bytes byte-identical on CUDA and CPU "
        f"(sha256 {ha[:16]})")
    return True


def main(argv: Optional[Sequence[str]] = None) -> int:
    if argv:
        print(f"usage: python -m p64tpu_torch.tools.parity (no arguments; "
              f"got {list(argv)})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("parity: no CUDA device -- the gate holds the card's paths "
              "to the CPU and an oracle, so it needs a card",
              file=sys.stderr)
        return 2
    log(f"device = {torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, cuda {torch.version.cuda}")
    results: List[bool] = [check_sad("cuda"), check_dct("cuda"),
                           check_encode_cross_device()]
    ok = all(results)
    log("PARITY PASS" if ok else "PARITY FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
