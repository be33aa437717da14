"""Digests of a rate-controlled QCIF encode, pinned from the JAX package.

One small batch -- 3 streams x 5 frames of the golden QCIF inter content,
each stream shifted sideways, at 960 kbit/s with 1 and with 3 MQUANT
segments a GOB: every frame coded, quantizers from 8 to 31, MQUANT MBs with
3 segments -- and the SHA-256 of every output and of the final state that
the JAX package gives for it on the CPU.  `test_torch_graphs` holds the JAX
package and the port's CPU encode to these digests; `test_torch_cuda` holds
the card's encode, whose rate chain runs `csrc/rate_chain.cu`, to them.
This module imports no JAX, so the card tests run without it.

After a deliberate change of the bitstream, regenerate the file on a host
with the JAX package:

    python tests/rate_goldens.py
"""

import hashlib
import json
import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "rate_goldens.json")
STREAMS, FRAMES = 3, 5
BIT_RATE = 960_000
#: MQUANT segments a GOB of each case
SEGMENTS = (1, 3)


def frames():
    """The batch as (S, T, ...) uint8 planes, from the port's copy of the
    golden content (held to the JAX package's by test_torch_imports)."""
    from p64tpu_torch.tools import golden_content as gc

    one = gc.config2_qcif_inter()
    return {k: np.stack([np.roll(v[:FRAMES], 7 * i, axis=-1)
                         for i in range(STREAMS)]) for k, v in one.items()}


def config(nseg: int):
    """The port's EncoderConfig of a case."""
    from p64tpu_torch.control.ratecontrol import RateConfig
    from p64tpu_torch.core import encoder
    from p64tpu_torch.spec.constants import QCIF

    return encoder.EncoderConfig(fmt=QCIF, rate=RateConfig(
        bit_rate=BIT_RATE, mquant_segments=nseg))


def digests(arrays) -> dict:
    """name -> SHA-256 of the array's shape and of its values widened to
    int64 (integers, booleans) or float64, so a value, not a dtype, is
    pinned."""
    out = {}
    for k, v in sorted(arrays.items()):
        a = np.asarray(v)
        a = a.astype(np.float64 if a.dtype.kind == "f" else np.int64)
        h = hashlib.sha256(repr(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
        out[k] = h.hexdigest()
    return out


def port_digests(state, out) -> dict:
    """{"outputs": ..., "state": ...} of a port encode (any device)."""
    from p64tpu_torch.core import encoder

    return {"outputs": digests({k: v.cpu().numpy() for k, v in out.items()}),
            "state": digests(encoder.state_to_numpy(state))}


def jax_digests(nseg: int) -> dict:
    """The same digests of the JAX package's encode, stream by stream."""
    import jax.numpy as jnp

    from p64tpu.control.ratecontrol import RateConfig
    from p64tpu.core import encoder as jenc
    from p64tpu.spec.constants import QCIF

    cfg = jenc.EncoderConfig(fmt=QCIF, rate=RateConfig(
        bit_rate=BIT_RATE, mquant_segments=nseg))
    batch = frames()
    runs = [jenc.encode_sequence_jit(
        cfg, {k: jnp.asarray(v[i]) for k, v in batch.items()},
        jenc.init_state(cfg)) for i in range(STREAMS)]
    stack = lambda d: {k: np.stack([np.asarray(r[d][k]) for r in runs])  # noqa: E731
                       for k in runs[0][d]}
    return {"outputs": digests(stack(1)), "state": digests(stack(0))}


def pinned() -> dict:
    """Segments (as a string) -> the pinned digests."""
    with open(PATH) as f:
        return json.load(f)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    with open(PATH, "w") as f:
        json.dump({str(n): jax_digests(n) for n in SEGMENTS}, f, indent=1,
                  sort_keys=True)
        f.write("\n")
