"""Deterministic YUV content for the pinned goldens and the parity gate.

The port's copy of `p64tpu.tools.golden_content`; tests/test_torch_imports.py
holds the two to equal frames.  Each configuration gets a sequence that
exercises the decisions that could diverge (SAD near-ties, quantizer
dead-zone edges, rate-control pressure), because a "friendly" sequence can
mask a wrong tie-break.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _chroma(y: np.ndarray) -> Dict[str, np.ndarray]:
    cb = (y[:, ::2, ::2] // 2 + 64).astype(np.uint8)
    cr = (255 - y[:, 1::2, ::2] // 2).astype(np.uint8)
    return dict(y=y.astype(np.uint8), cb=cb, cr=cr)


def config1_qcif_intra() -> Dict[str, np.ndarray]:
    """BASELINE config 1: one QCIF frame, intra-only, fixed quantizer."""
    h, w = 144, 176
    rng = np.random.default_rng(101)
    yy, xx = np.mgrid[0:h, 0:w]
    y = ((xx * 5 + yy * 3) // 4 % 200 + 20).astype(np.int32)
    y += rng.integers(-8, 9, (h, w))
    return _chroma(np.clip(y, 0, 255)[None].astype(np.uint8))


def config2_qcif_inter(t: int = 10) -> Dict[str, np.ndarray]:
    """BASELINE config 2: 10-frame QCIF, intra + inter with full search.

    Moving square + periodic background (exact SAD ties every 8-pel shift)
    + scene cut at frame 6 + mild noise: the adversarial mix."""
    h, w = 144, 176
    rng = np.random.default_rng(202)
    yy, xx = np.mgrid[0:h, 0:w]
    per = (((xx % 8 < 4) ^ (yy % 8 < 4)) * 150 + 50).astype(np.int32)
    frames = []
    for i in range(t):
        f = np.roll(per, i * 2, axis=1).copy()
        if i >= 6:
            f = 255 - f
        y0, x0 = 20 + 4 * i, 30 + 6 * i
        f[y0:y0 + 32, x0:x0 + 32] = 200
        f = f + rng.integers(0, 5, (h, w))
        frames.append(np.clip(f, 0, 255))
    return _chroma(np.stack(frames).astype(np.uint8))


def config3_cif_rc(t: int = 30) -> Dict[str, np.ndarray]:
    """BASELINE config 3: 30-frame CIF under rate control -- content whose
    complexity ramps so the buffer-feedback quantizer must adapt."""
    h, w = 288, 352
    rng = np.random.default_rng(303)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((16 + (xx * 3 + yy * 2) // 8) % 200).astype(np.int32)
    frames = []
    for i in range(t):
        f = base.copy()
        # growing noisy region: bits/frame rise over time
        k = 16 + 8 * i
        f[:k, :k] += rng.integers(0, 60, (min(k, h), min(k, w)))
        x0 = (10 + 7 * i) % (w - 48)
        f[40:88, x0:x0 + 48] += 50
        frames.append(np.clip(f, 0, 255))
    return _chroma(np.stack(frames).astype(np.uint8))


def kernel_probe_blocks() -> Dict[str, np.ndarray]:
    """Single-MB images isolating per-kernel rounding: encoded intra-only at several quantizers,
    the resulting TCOEFF bits pin down DCT rounding + quantizer dead-zone
    behavior one 8x8 block at a time."""
    h, w = 48, 48  # 3x3 MBs, QCIF-legal dims are not required for probes
    blocks = []
    # DC-only, ramp, checkerboard, impulse, max-contrast: span the DCT range
    flat = np.full((h, w), 128)
    ramp = np.add.outer(np.arange(h) * 4, np.arange(w) * 2) % 256
    checker = (((np.arange(h)[:, None] + np.arange(w)) % 2) * 255)
    imp = flat.copy()
    imp[::8, ::8] = 255
    maxc = np.where((np.arange(h)[:, None] // 8 + np.arange(w) // 8) % 2,
                    255, 0)
    for b in (flat, ramp, checker, imp, maxc):
        blocks.append(b)
    return _chroma(np.stack(blocks).astype(np.uint8))


def adversarial_sequences() -> Dict[str, np.ndarray]:
    """Dict of name -> (T, H, W) uint8 luma sequences (QCIF) designed to
    surface SAD near-ties and threshold-edge decisions.  Shared by the
    hardware parity gate (tools/parity.py) and the pinned-golden
    regression test so they can never drift apart."""
    h, w, t = 144, 176, 5
    rng = np.random.default_rng(20260819)
    seqs = {}
    seqs["noise"] = rng.integers(0, 256, (t, h, w)).astype(np.uint8)
    # scene cut at frame 2
    a = rng.integers(0, 256, (h, w))
    b = rng.integers(0, 256, (h, w))
    seqs["scenecut"] = np.stack([a, a, b, b, b]).astype(np.uint8)
    # periodic texture: every 8-pel shift is an exact SAD tie
    yy, xx = np.mgrid[0:h, 0:w]
    per = ((xx % 8 < 4) ^ (yy % 8 < 4)).astype(np.uint8) * 180 + 40
    seqs["periodic"] = np.stack(
        [np.roll(per, i, axis=1) for i in range(t)]).astype(np.uint8)
    # smooth gradient + moving square + mild noise (near-threshold deltas)
    frames = []
    base = (16 + (xx * 3 + yy * 2) // 8) % 220
    for i in range(t):
        f = base.copy()
        f[(30 + 3 * i):(30 + 3 * i) + 32, (20 + 5 * i):(20 + 5 * i) + 32] += 40
        f = f + rng.integers(0, 3, (h, w))
        frames.append(np.clip(f, 0, 255))
    seqs["smooth"] = np.stack(frames).astype(np.uint8)
    return seqs


def luma_to_frames(y: np.ndarray) -> Dict[str, np.ndarray]:
    """Derive the standard deterministic chroma for a luma sequence (the
    same formula the parity gate uses)."""
    return _chroma(y)


def graded_energy_qcif() -> Dict[str, np.ndarray]:
    """One QCIF frame whose per-MB texture energy decays along the raster
    MB index: segment 0 of GOB 0 is expensive, later segments cheap -- the
    shape on which the one-pass (q0-only) MQUANT cost model provably
    mispredicts later segments' buffer state.  Shared by
    the MQUANT cost-model tests and the `mquant2pass` pinned golden."""
    rng = np.random.default_rng(1)
    h, w = 144, 176
    y = np.zeros((h, w), np.uint8)
    for r in range(h // 16):
        for c in range(w // 16):
            k = r * (w // 16) + c
            amp = max(4, 90 - 3 * k)
            y[r * 16:(r + 1) * 16, c * 16:(c + 1) * 16] = np.clip(
                128 + rng.integers(-amp, amp + 1, (16, 16)), 0, 255)
    cb = np.full((h // 2, w // 2), 128, np.uint8)
    return dict(y=y[None], cb=cb[None], cr=cb[None])


ALL = {
    "config1_qcif_intra": config1_qcif_intra,
    "config2_qcif_inter": config2_qcif_inter,
    "config3_cif_rc": config3_cif_rc,
}
