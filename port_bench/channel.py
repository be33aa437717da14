"""A line that corrupts bits: what a configuration's `channel` states.

`{"bit_error_rate": p}` flips each of a stream's `nbits` coded bits on its
own with probability p (the padding after them is left as it is): the
count from a binomial draw, the positions a uniform draw of that many
distinct bits, from a generator seeded by the run's seed and the stream's
index.  So every job of a run decodes the same damaged bytes, and one seed
gives the same bytes in every run."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def check(channel: dict) -> float:
    """The bit error rate a `channel` states; raises ValueError where it
    states anything else."""
    if set(channel) != {"bit_error_rate"}:
        raise ValueError(f"a channel states bit_error_rate alone, not "
                         f"{sorted(channel)}")
    p = channel["bit_error_rate"]
    if not isinstance(p, (int, float)) or not 0 <= p < 1:
        raise ValueError(f"bit_error_rate {p!r} is not a rate in [0, 1)")
    return float(p)


def flip(streams: Sequence[Tuple[bytes, int]], bit_error_rate: float,
         seed: int) -> Tuple[List[bytes], List[int]]:
    """Each stream's bytes after the line, and the bits flipped in each."""
    datas, flips = [], []
    for i, (data, nbits) in enumerate(streams):
        rng = np.random.default_rng([seed % (1 << 64), i])
        at = rng.choice(nbits, rng.binomial(nbits, bit_error_rate),
                        replace=False)
        out = np.frombuffer(data, np.uint8).copy()
        np.bitwise_xor.at(out, at >> 3, (0x80 >> (at & 7)).astype(np.uint8))
        datas.append(out.tobytes())
        flips.append(len(at))
    return datas, flips
