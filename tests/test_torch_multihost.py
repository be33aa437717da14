"""The port's multi-process glue over torch.distributed: two gloo worker
processes on the CPU, each encoding its half of the streams, agree with
the port's single-process run and the JAX package's `encode_shard` in the
all-reduced aggregates, the all-gathered bit lengths and every stream's
bytes.

The worker is this file run as a script:

    python tests/test_torch_multihost.py RANK WORLD PORT
"""

import hashlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from p64tpu_torch.control.ratecontrol import RateConfig
from p64tpu_torch.core import encoder as enc
from p64tpu_torch.distrib import mesh as dm
from p64tpu_torch.distrib import multihost
from p64tpu_torch.spec.constants import QCIF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STREAMS, N_FRAMES, SEARCH, WORLD = 4, 2, 2, 2
RATE = dict(bit_rate=192_000, frame_rate=30)
#: seconds each worker may take before both are killed
WORKER_TIMEOUT = 120


def _frames():
    rng = np.random.default_rng(31)
    y = (rng.integers(0, 256, (N_STREAMS, N_FRAMES, QCIF.height, QCIF.width),
                      dtype=np.uint8) // 4 + 96).astype(np.uint8)
    return dict(y=y, cb=y[:, :, ::2, ::2].copy(), cr=y[:, :, 1::2, ::2].copy())


def _cfg():
    return enc.EncoderConfig(fmt=QCIF, search=SEARCH, emit_recon=False,
                             rate=RateConfig(**RATE))


def _summary(agg, streams, lengths):
    return dict(total_bits=dm.agg_total_bits(agg),
                frames_coded=int(agg["frames_coded"]),
                lengths=[int(n) for n in lengths],
                sha256=[hashlib.sha256(b).hexdigest() for b, _ in streams])


def _worker(rank, world, port):
    """Encode this rank's contiguous share of the streams on the CPU and
    print one JSON line of what it saw."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")
    try:
        n = N_STREAMS // world
        local = {k: v[rank * n:(rank + 1) * n] for k, v in _frames().items()}
        mesh = multihost.global_mesh(["cpu"])
        _, outputs, agg = multihost.encode_global(_cfg(), mesh, local)
        streams = multihost.finalize_local(_cfg(), outputs)
        lengths = multihost.gather_stream_lengths([b for _, b in streams])
        print(json.dumps(dict(rank=rank, **_summary(agg, streams, lengths))))
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(WORLD),
         str(port)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    deadline = time.monotonic() + WORKER_TIMEOUT
    try:
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


def test_two_gloo_processes_match_one_process_and_jax():
    from p64tpu.control.ratecontrol import RateConfig as JRateConfig
    from p64tpu.core import encoder as jenc
    from p64tpu.spec.constants import QCIF as JQCIF
    from p64tpu.tools import batch_encode as jbatch

    got = _run_workers()

    frames = _frames()
    mesh = dm.make_mesh(devices=["cpu"])
    run = dm.make_sharded_encoder(_cfg(), mesh)
    _, outputs, agg = run(dm.shard_batch(mesh, dm.init_states(_cfg(),
                                                               N_STREAMS)),
                          dm.shard_batch(mesh, frames))
    streams = dm.serialize_streams(_cfg(), outputs)
    one = _summary(agg, streams, [b for _, b in streams])
    jcfg = jenc.EncoderConfig(fmt=JQCIF, search=SEARCH, emit_recon=False,
                              rate=JRateConfig(**RATE))
    jstreams = jbatch.encode_shard(jcfg, frames)
    assert [b for b, _ in jstreams] == [b for b, _ in streams]
    assert one["lengths"] == [b for _, b in jstreams]
    assert one["total_bits"] == sum(one["lengths"])

    n = N_STREAMS // WORLD
    for rank, g in enumerate(got):
        assert g["rank"] == rank
        assert g["total_bits"] == one["total_bits"]
        assert g["frames_coded"] == one["frames_coded"]
        assert g["lengths"] == one["lengths"]
        assert g["sha256"] == one["sha256"][rank * n:(rank + 1) * n]


def test_single_process_needs_no_process_group():
    multihost.initialize(None, 1, 0, backend="gloo")
    import torch.distributed as dist
    assert not dist.is_initialized()
    np.testing.assert_array_equal(
        multihost.gather_stream_lengths([5, 7]), np.asarray([5, 7]))


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
