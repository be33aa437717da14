"""Where does the build of the encoder's captured program go?

    python -m p64tpu_torch.tools.capture_probe            # all variants
    python -m p64tpu_torch.tools.capture_probe base16 s1  # a subset

Port of the repository's `tools/compile_probe.py`.  The reference times
trace+lower and XLA's backend compile of the jitted, vmapped encode, for
program variants that each remove one suspected cost.  The port's
counterpart of that compile is the build of the frame step's CUDA graph
(`core.graphs`), so per variant this times

  warm-up -- the eager frame step on the capture's side stream (first use
             of the kernel library, the device tables and cuBLAS)
  capture -- `torch.cuda.graph` around one frame step, instantiation
             included
  replay  -- the first replay: the rest of a one-frame call (copy in,
             replay, copy out) up to torch.cuda.synchronize()

and then the steady-state encode of the variant's T frames (every frame a
replay) and the graph's pool: the growth of reserved device memory over
the capture.  Each variant builds in a cache of its own, so every build is
a genuine first one; the kernel library is built and loaded before the
first variant.

Variants (the reference's; CIF, fixed quantizer 10, zero frames):

  base16    16 streams, 32 frames, search 15
  s1        1 stream                (stream width)
  f2        2 frames                (sequence length: only the replay
                                     count, since the graph is one step)
  search7   search 7
  intra     no ME/MC at all
  base64    64 streams              (run last)

The reference's `xla_me` (the XLA SAD formulation in place of the Pallas
kernel) has no counterpart: on a card the port has one search path, the
hand-written SAD-search kernel (`kernels/me_cuda.py`); its plain torch
version runs on the CPU and in the parity checks, never inside a captured
program.

Output: one markdown table on stdout, progress on stderr.  Needs a card;
exits 2 without one.
"""

from __future__ import annotations

import sys
import time

import torch

from ..control.ratecontrol import RateConfig
from ..core import encoder as enc
from ..core import graphs
from ..kernels import me_cuda
from ..spec.constants import CIF
from ..utils import card_line

VARIANTS = ("base16", "s1", "f2", "search7", "intra", "base64")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def variant(name: str) -> dict:
    """The variant's shape: streams, frames, search and intra_only."""
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}; expected some of "
                         f"{VARIANTS}")
    v = dict(streams=16, frames=32, search=15, intra_only=False)
    v.update({"s1": dict(streams=1), "f2": dict(frames=2),
              "search7": dict(search=7), "intra": dict(intra_only=True),
              "base64": dict(streams=64)}.get(name, {}))
    return v


def probe(name: str, device: torch.device) -> dict:
    """Build the variant's program in a cache of its own and time it (see
    the module docstring).  Returns dict(name, warmup_s, capture_s,
    replay_ms, encode_ms, frames, pool_mb, launches)."""
    v = variant(name)
    cfg = enc.EncoderConfig(fmt=CIF, search=v["search"],
                            intra_only=v["intra_only"],
                            rate=RateConfig(fixed_quant=10))
    s, t = v["streams"], v["frames"]
    shapes = dict(y=(CIF.height, CIF.width),
                  cb=(CIF.chroma_height, CIF.chroma_width),
                  cr=(CIF.chroma_height, CIF.chroma_width))
    frames = {k: torch.zeros((s, t, *hw), dtype=torch.uint8, device=device)
              for k, hw in shapes.items()}
    cache = graphs.ProgramCache(1)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    enc.encode_sequence_graphed(cfg, {k: f[:, :1] for k, f in frames.items()},
                                device=device, cache=cache)
    torch.cuda.synchronize(device)
    first_s = time.perf_counter() - t0
    ((_, prog),) = cache.items()
    cap = prog.captured
    t0 = time.perf_counter()
    _, out = enc.encode_sequence_graphed(cfg, frames, device=device,
                                         cache=cache)
    int(out["total_bits"].sum())                 # waits for the device
    encode_s = time.perf_counter() - t0
    return dict(name=name, warmup_s=cap.warmup_s, capture_s=cap.capture_s,
                replay_ms=(first_s - cap.warmup_s - cap.capture_s) * 1e3,
                encode_ms=encode_s * 1e3, frames=t,
                pool_mb=cap.pool_bytes / 2 ** 20, launches=cap.launches)


def main(argv=None) -> int:
    names = list(sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    bad = [n for n in names if n not in VARIANTS]
    if bad:
        print(f"capture_probe: unknown variants {bad}; expected some of "
              f"{VARIANTS}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("capture_probe: no CUDA device -- the probe times the card's "
              "graph capture", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    me_cuda._lib()                     # the kernel build is not the probe's
    log(f"capture probe: {card_line()} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}, variants {names}")
    rows = []
    for n in names:
        r = probe(n, device)
        rows.append(r)
        log(f"{n}: warm-up {r['warmup_s']:.3f} s, capture "
            f"{r['capture_s']:.3f} s, first replay {r['replay_ms']:.2f} ms, "
            f"{r['frames']} frames {r['encode_ms']:.1f} ms, pool "
            f"{r['pool_mb']:.1f} MB, {r['launches']} SAD-search launches "
            "per replay")
    print("| variant | warm-up s | capture s | first replay ms | encode ms "
          "(frames) | pool MB |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['name']} | {r['warmup_s']:.3f} | {r['capture_s']:.3f} | "
              f"{r['replay_ms']:.2f} | {r['encode_ms']:.1f} ({r['frames']}) "
              f"| {r['pool_mb']:.1f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
