"""Host-side bit-level I/O.

The port's copy of `p64tpu.entropy.bitio`.  The encoder never touches bits
on its serial path: the device emits dense symbol tensors plus exact bit
*lengths*, and this module converts whole symbol arrays to bytes in a few
vectorized numpy passes (`pack_symbols`).  The native engine
(`p64tpu_torch/csrc/bitio.cpp`, bound in `p64tpu_torch.native`) has the same
contract for the large-scale path; this file is the portable implementation
and the correctness oracle.

Bit order: MSB-first within each byte, matching H.261 transmission order.
"""

from __future__ import annotations

import numpy as np


def pack_symbols(codes: np.ndarray, lens: np.ndarray) -> tuple[bytes, int]:
    """Concatenate VLC codes into a byte string.

    Args:
      codes: uint32/uint64 array; the low `lens[i]` bits of `codes[i]` are the
        i-th codeword (MSB of the codeword transmitted first).
      lens: int array of bit lengths (0 entries are skipped).

    Returns:
      (bytes, total_bits).  The final partial byte is zero-padded.
    """
    codes = np.asarray(codes, dtype=np.uint64)
    lens = np.asarray(lens, dtype=np.int64)
    keep = lens > 0
    codes, lens = codes[keep], lens[keep]
    total = int(lens.sum())
    if total == 0:
        return b"", 0
    ends = np.cumsum(lens)
    starts = ends - lens
    bits = np.zeros(total, dtype=np.uint8)
    maxlen = int(lens.max())
    # One vector op per bit position within a codeword (<= 20 for H.261).
    for b in range(maxlen):
        m = lens > b
        shift = (lens[m] - 1 - b).astype(np.uint64)
        bits[starts[m] + b] = (codes[m] >> shift) & np.uint64(1)
    return np.packbits(bits).tobytes(), total


class BitWriter:
    """Append-oriented writer for small/serial uses (headers, tests)."""

    def __init__(self) -> None:
        self._codes: list[int] = []
        self._lens: list[int] = []

    def put(self, value: int, nbits: int) -> None:
        assert 0 <= nbits <= 64
        assert 0 <= value < (1 << nbits) if nbits else value == 0
        self._codes.append(value)
        self._lens.append(nbits)

    def put_str(self, bitstring: str) -> None:
        if bitstring:
            self.put(int(bitstring, 2), len(bitstring))

    @property
    def nbits(self) -> int:
        return int(sum(self._lens))

    def getvalue(self) -> bytes:
        data, _ = pack_symbols(
            np.asarray(self._codes, dtype=np.uint64),
            np.asarray(self._lens, dtype=np.int64),
        )
        return data


class BitReader:
    """MSB-first reader with arbitrary-width peek (zero-padded past EOF),
    built on an unpacked bit array for simplicity and exactness."""

    def __init__(self, data: bytes) -> None:
        self._bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
        self.pos = 0

    @property
    def nbits(self) -> int:
        return int(self._bits.size)

    @property
    def remaining(self) -> int:
        return self.nbits - self.pos

    def peek(self, n: int) -> int:
        """Next n bits as an integer; bits past EOF read as 0."""
        end = min(self.pos + n, self.nbits)
        chunk = self._bits[self.pos:end]
        v = 0
        for b in chunk:
            v = (v << 1) | int(b)
        return v << (n - (end - self.pos))

    def read(self, n: int) -> int:
        if self.pos + n > self.nbits:
            raise EOFError(f"read past end of stream at bit {self.pos}")
        v = self.peek(n)
        self.pos += n
        return v

    def skip(self, n: int) -> None:
        self.pos += n

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7
