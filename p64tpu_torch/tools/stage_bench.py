"""Per-stage device timing for the encoder hot path of the PyTorch port.

    python -m p64tpu_torch.tools.stage_bench [stage ...]   (default: all)
    P64_STAGE_STREAMS=128 P64_STAGE_ITERS=30 python -m p64tpu_torch.tools.stage_bench

Port of the repository's `tools/stage_bench.py`: the same nine stages under
the same names, inputs drawn from `default_rng(0)` in the reference's call
order, and each stage run ITERS times with the reference's carried
perturbation (iteration i adds i & 1 to the stage's input) and an
accumulated checksum, so every output is consumed.  The port's functions
are batch-first, so each stage takes all streams at once where the
reference maps one stream with `jax.vmap`.

Two inputs differ from the reference's, because the port's kernels have
stricter contracts than the reference's CPU path: `me_full_search` casts
its perturbed plane (0..511) to uint8 modulo 256, as `frame_step` already
does, since the SAD-search kernel takes uint8 planes; and `mc_predict` and
`reconstruct` clip the random motion vectors so that each 16x16 block
stays inside the picture (the ME window clip guarantees that on the
encoder's path), since the port's gather refuses an out-of-picture index
where the reference's zero-padded select reads zeros.

The reference jits each stage's whole loop (`jax.jit(lambda: loop(fn,
x0))`), so its CUDA-events span is device time.  Here the whole loop is
captured as one CUDA graph (`core.graphs.capture`) and replayed, which is
the same thing on a card.  Each stage is timed three ways, each the best
of 2 loops, per iteration:
  device -- CUDA events around one replay of the captured loop: the
            device's own time, with no host launch in it;
  busy   -- the sum of the kernel durations (torch.profiler) of one more
            loop, run eagerly;
  wall   -- the host clock around the loop run eagerly, ending in
            torch.cuda.synchronize(): what the launches from Python cost.
wall - device is what eager launching adds.  The replay's checksum must
equal the eager loop's.  Output (stderr): per stage those three numbers
and the checksum's low 16 bits, as the reference logs it.  Needs a card;
exits 2 without one.  The tests call `run_stages` on the CPU, where only
the eager wall time and the checksum exist.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..control.decisions import DecisionConfig, decide_modes
from ..control.ratecontrol import RateConfig
from ..core import encoder as enc
from ..core import graphs
from ..core.blocks import luma_to_mbs, to_gob_order
from ..core.predict import mc_predict
from ..core.reconstruct import reconstruct_frame
from ..entropy import lengths
from ..kernels.dct import fdct8x8_zz
from ..kernels.me import full_search
from ..kernels.quant import quantize_zz
from ..spec.constants import CIF, MB_SIZE, Format
from ..utils import card_line

#: the stages, in the reference's order
STAGES = ("me_full_search", "mc_predict", "decide_modes", "fdct",
          "quant_plus_lengths", "quantize_only", "block_bits_only",
          "reconstruct", "frame_step")
#: timed loops per stage (the reference's best of 2)
ROUNDS = 2

Stage = Tuple[Callable[[torch.Tensor], torch.Tensor], torch.Tensor]


class StageTime(NamedTuple):
    """Per-iteration times of one stage in milliseconds -- device (the
    captured loop's replay), wall and busy (the loop run eagerly); device
    and busy are None off a card -- and the loop's checksum as a signed
    int32, the reference's accumulator."""
    device_ms: Optional[float]
    wall_ms: float
    checksum: int
    busy_ms: Optional[float]


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def wrap32(v: int) -> int:
    """v modulo 2^32 as a signed int32: the reference sums in int32."""
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def legal_mvs(fmt: Format, mv: torch.Tensor) -> torch.Tensor:
    """(S, nMB, 2) (mvx, mvy) clipped so that each MB's 16x16 block stays
    inside the picture (then its halved chroma vector keeps its 8x8 block
    inside too)."""
    idx = torch.arange(fmt.num_mbs, device=mv.device)
    y0 = (idx // fmt.mb_cols) * MB_SIZE
    x0 = (idx % fmt.mb_cols) * MB_SIZE
    mvx = torch.minimum(torch.maximum(mv[..., 0], -x0),
                        fmt.width - MB_SIZE - x0)
    mvy = torch.minimum(torch.maximum(mv[..., 1], -y0),
                        fmt.height - MB_SIZE - y0)
    return torch.stack([mvx, mvy], dim=-1).to(mv.dtype)


def make_stages(streams: int, device: torch.device | str) -> Dict[str, Stage]:
    """name -> (fn, x0) at `streams` CIF streams: fn(x0 + (i & 1)) is
    iteration i of the stage and returns a 0-dim int64 sum of its outputs
    on `device`."""
    fmt = CIF
    dev = torch.device(device)
    n_mb = fmt.num_mbs
    h, w = fmt.height, fmt.width
    rng = np.random.default_rng(0)

    def t(a) -> torch.Tensor:
        return torch.as_tensor(a, device=dev)

    # the reference's draws, in its order (it also draws mtype, cbp and
    # coded last and never uses them)
    cur_y = t(rng.integers(0, 256, (streams, h, w), np.int32))
    ref_y = t(rng.integers(0, 256, (streams, h, w), np.uint8))
    ref_cb = t(rng.integers(0, 256, (streams, h // 2, w // 2), np.uint8))
    ref_cr = ref_cb
    mv = t(rng.integers(-15, 16, (streams, n_mb, 2), np.int32))
    fil = t(rng.integers(0, 2, (streams, n_mb)).astype(bool))
    intra = t(rng.integers(0, 4, (streams, n_mb)) == 0)
    levels = t(rng.integers(-8, 9, (streams, n_mb, 6, 64), np.int32)
               * (rng.random((streams, n_mb, 6, 64)) < 0.1))
    quant_mb = torch.full((streams, n_mb), 10, dtype=torch.int32, device=dev)
    blocks = t(rng.integers(-255, 256, (streams, n_mb, 6, 8, 8), np.int32))
    coefs = t(rng.integers(-2047, 2048, (streams, n_mb, 6, 8, 8), np.int32))
    mv_in = legal_mvs(fmt, mv)
    q10 = torch.tensor(10, dtype=torch.int32, device=dev)
    cbp_weights = t(np.asarray([32, 16, 8, 4, 2, 1], np.int32))
    cfg = enc.EncoderConfig(fmt=fmt, search=15,
                            rate=RateConfig(fixed_quant=10))

    def st_me(pert):
        plane = ((cur_y + pert) & 255).to(torch.uint8)
        mv_, bs, s0 = full_search(plane, ref_y, 15)
        return mv_.sum() + bs.sum() + s0.sum()

    def st_pred(pert):
        py, pcb, pcr = mc_predict(ref_y, ref_cb, ref_cr, mv_in + pert * 0,
                                  fil, fmt)
        return py.sum() + pcb.sum() + pcr.sum()

    def st_dec(pert):
        cur_mbs = luma_to_mbs(cur_y)
        pred0 = luma_to_mbs(ref_y.to(torch.int32))
        full = torch.full((streams, n_mb), 1000, dtype=torch.int32,
                          device=dev)
        d = decide_modes(cur_mbs, pred0, pred0, full + cur_y[:, :1, 0],
                         torch.full_like(full, 900),
                         torch.zeros((streams, n_mb, 2), dtype=torch.int32,
                                     device=dev),
                         torch.zeros_like(full),
                         torch.zeros(streams, dtype=torch.bool, device=dev),
                         DecisionConfig())
        return d["mv_out"].sum() + d["intra"].sum()

    def st_dct(pert):
        return fdct8x8_zz(blocks + pert).sum()

    def st_quant_len(pert):
        c_t = to_gob_order(fmt, coefs + pert).reshape(
            streams, fmt.num_gobs, 33, 6, 64)
        i_t = to_gob_order(fmt, intra)
        m_t = to_gob_order(fmt, mv)
        lv = quantize_zz(c_t, q10, i_t[..., None, None])
        cbp_ = torch.where((lv != 0).any(dim=-1), cbp_weights, 0).sum(
            dim=-1, dtype=torch.int32)
        mt = torch.where(i_t, 0, 3)
        return lengths.gob_payload_bits(cbp_ > 0, mt, m_t, cbp_, lv).sum()

    def st_quant(pert):
        zz = (coefs + pert).reshape(streams, n_mb, 6, 64)
        return quantize_zz(zz, q10, intra[..., None, None]).sum()

    def st_blockbits(pert):
        return lengths.block_bits(levels + pert * 0 + (pert & 1),
                                  intra[..., None]).sum()

    def st_recon(pert):
        y, cb, cr = reconstruct_frame(fmt, levels + pert * 0, quant_mb,
                                      intra, mv_in, fil, ref_y, ref_cb,
                                      ref_cr)
        return y.sum() + cb.sum() + cr.sum()

    def st_frame(pert):
        # the result depends on the new state too, so nothing of the step
        # is idle work
        state = enc.init_state(cfg, streams, dev)
        state.update(frame_idx=state["frame_idx"] + 1, ref_y=ref_y)
        plane = ((cur_y + pert) & 255).to(torch.uint8)
        st2, out = enc.encode_frame_step(cfg, state, plane, ref_cb, ref_cr)
        return (out["total_bits"].sum() + st2["ref_y"].sum()
                + st2["refresh"].sum())

    return {"me_full_search": (st_me, cur_y), "mc_predict": (st_pred, mv),
            "decide_modes": (st_dec, cur_y), "fdct": (st_dct, blocks),
            "quant_plus_lengths": (st_quant_len, coefs),
            "quantize_only": (st_quant, coefs),
            "block_bits_only": (st_blockbits, levels),
            "reconstruct": (st_recon, levels),
            "frame_step": (st_frame, cur_y)}


def loop(stage: Stage, iters: int) -> torch.Tensor:
    """Run the stage `iters` times with the carried perturbation; returns
    the accumulated 0-dim int64 sum (not yet read)."""
    fn, x0 = stage
    acc = torch.zeros((), dtype=torch.int64, device=x0.device)
    for i in range(iters):
        acc = acc + fn(x0 + (i & 1))
    return acc


def _busy_ms(stage: Stage, iters: int) -> Optional[float]:
    """Sum of the durations of the device activities (kernels, copies) of
    one loop, from torch.profiler, per iteration; None if the profiler saw
    no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        int(loop(stage, iters))
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    return total_us / 1e3 / iters if total_us > 0 else None


def _graph_ms(stage: Stage, iters: int, checksum: int,
              dev: torch.device) -> float:
    """Capture the whole loop as one CUDA graph and replay it: the best of
    ROUNDS replays' CUDA-events span, per iteration.  Raises if a replay's
    checksum differs from the eager loop's `checksum`."""
    captured = graphs.capture(lambda: loop(stage, iters),
                              lambda: loop(stage, iters), dev)
    best = float("inf")
    for _ in range(ROUNDS):
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        captured.replay()
        end.record()
        torch.cuda.synchronize(dev)
        best = min(best, start.elapsed_time(end))
        got = int(captured.result)
        if got != checksum:
            raise AssertionError(f"the captured loop's checksum {got} != "
                                 f"the eager loop's {checksum}")
    return best / iters


def run_stages(names: Sequence[str], streams: int, iters: int, *,
               device: torch.device | str) -> Dict[str, StageTime]:
    """Time each named stage at `streams` CIF streams on `device` (see the
    module docstring); returns name -> StageTime."""
    unknown = [n for n in names if n not in STAGES]
    if unknown:
        raise ValueError(f"unknown stages {unknown}; expected some of "
                         f"{STAGES}")
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    stages = make_stages(streams, dev)
    out = {}
    for name in names:
        stage = stages[name]
        t0 = time.perf_counter()
        r = int(loop(stage, iters))
        log(f"{name}: first run {time.perf_counter() - t0:.1f}s")
        wall_best = float("inf")
        for _ in range(ROUNDS):
            if on_card:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            r = int(loop(stage, iters))                # waits for the device
            wall_best = min(wall_best, (time.perf_counter() - t0) * 1e3)
        res = StageTime(
            device_ms=_graph_ms(stage, iters, r, dev) if on_card else None,
            wall_ms=wall_best / iters, checksum=wrap32(r),
            busy_ms=_busy_ms(stage, iters) if on_card else None)
        out[name] = res
        log(f"{name}: device {_ms(res.device_ms)}, busy {_ms(res.busy_ms)}, "
            f"wall {_ms(res.wall_ms)} ms/iter  (checksum {r & 0xffff})")
    return out


def _ms(v: Optional[float]) -> str:
    return "n/a" if v is None else f"{v:.3f}"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not torch.cuda.is_available():
        print("stage_bench: no CUDA device -- the stage times are the "
              "card's", file=sys.stderr)
        return 2
    iters = int(os.environ.get("P64_STAGE_ITERS", "30"))
    streams = int(os.environ.get("P64_STAGE_STREAMS", "16"))
    log(f"{card_line()} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log(f"device={torch.cuda.get_device_name(0)} streams={streams} "
        f"iters={iters}")
    results = run_stages(argv or STAGES, streams, iters,
                         device=torch.device("cuda", 0))
    log(f"---- summary (ms per frame-step equivalent, {streams} CIF "
        "streams; captured device span, eager kernel busy, eager host "
        "wall) ----")
    for k, v in results.items():
        log(f"{k:22s} {_ms(v.device_ms):>8s} {_ms(v.busy_ms):>8s} "
            f"{_ms(v.wall_ms):>8s}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
