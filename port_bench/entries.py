"""The port entries a traffic mix can drive, by the name its `entry` gives.

Each entry makes its inputs from the seed in `setup` (its last act is one
whole warm-up job), runs one whole job per `job` call, counts what a job
returned, keeps what the check will compare, measures its host spans for a
traced run, and in `check` compares what it kept with the plain reference
(`reference/`), which runs on the same device as plain torch.  The port is
called only through `p64tpu_torch.tools.batch_encode.encode_resilient`,
`distrib.mesh`, `core.encoder.outputs_to_host`/`serialize_streams`,
`core.decoder.parse_to_tensors`/`stack_seqs`/`decode_seq_batch`,
`native.load` and `utils.fan_map`; it is told of a stream it refuses by
`entropy.parse.StreamError`.

`reference_job(precision)` is the entry's job done by the reference at a
lower precision of its transforms: the control (`control.py`) puts it in
the port's place.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import random
import time
import zipfile
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import channel as line
from .content import make_content
from .reference import constants as ref_constants
from .reference import dct as ref_dct
from .reference import decode as ref_decode
from .reference import encoder as ref_encoder
from .reference import playback as ref_playback
from .reference import ratecontrol as ref_ratecontrol
from .reference import serialize as ref_serialize

Check = Tuple[str, float, float]       # (name, value, limit)

#: streams the reference encodes at once (bounds its SAD map's memory,
#: about 3 GB at 128 CIF streams)
REFERENCE_STREAMS = 128


def _config_kwargs(config: dict) -> dict:
    return dict(search=config.get("search", 15),
                intra_only=config.get("intra_only", False),
                intra_period=config.get("intra_period", 0))


def port_config(config: dict):
    """The port's EncoderConfig of a configuration file."""
    from p64tpu_torch.control.ratecontrol import RateConfig
    from p64tpu_torch.core.encoder import EncoderConfig
    from p64tpu_torch.spec.constants import FORMATS
    return EncoderConfig(fmt=FORMATS[config["format"]],
                         rate=RateConfig(**config.get("rate", {})),
                         emit_recon=config.get("emit_recon", True),
                         **_config_kwargs(config))


def reference_config(config: dict) -> ref_encoder.EncoderConfig:
    """The reference's EncoderConfig of a configuration file."""
    return ref_encoder.EncoderConfig(
        fmt=ref_constants.FORMATS[config["format"]],
        rate=ref_ratecontrol.RateConfig(**config.get("rate", {})),
        **_config_kwargs(config))


def reference_encode(config: dict, frames: Dict[str, torch.Tensor],
                     keep: Tuple[str, ...] = ()):
    """The reference's bytes of every stream of `frames` (S, T, ...) on
    their device, REFERENCE_STREAMS at a time.  Returns (per stream
    (bytes, nbits), {key: host array (S, T, ...)} of the output keys in
    `keep`)."""
    cfg = reference_config(config)
    s = frames["y"].shape[0]
    streams, kept = [], {k: [] for k in keep}
    for b in range(0, s, REFERENCE_STREAMS):
        _, out = ref_encoder.encode_sequence(
            cfg, {k: v[b:b + REFERENCE_STREAMS] for k, v in frames.items()})
        bits = out["total_bits"].sum(dim=1).tolist()
        got = ref_serialize.serialize_streams(cfg.fmt, out)
        if [n for _, n in got] != bits:
            raise AssertionError("reference serializer and bit model "
                                 "disagree")
        streams += got
        for k in keep:
            kept[k].append(out[k].cpu().numpy())
        del out
    return streams, {k: np.concatenate(v) for k, v in kept.items()}


def _stream_digest(data: np.ndarray, lengths: np.ndarray,
                   nbits: np.ndarray) -> np.ndarray:
    h = hashlib.sha256()
    for a in (data, lengths, nbits):
        h.update(np.ascontiguousarray(a).tobytes())
    return np.frombuffer(h.digest(), dtype=np.uint8)


def save_streams(path: str, streams: List[Tuple[bytes, int]]) -> None:
    """Write per-stream (bytes, nbits) to `path` with the sha256 of its
    content, through a file beside it that replaces it whole."""
    data = np.frombuffer(b"".join(d for d, _ in streams), dtype=np.uint8)
    lengths = np.array([len(d) for d, _ in streams], dtype=np.int64)
    nbits = np.array([n for _, n in streams], dtype=np.int64)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".part", "wb") as f:
        np.savez(f, data=data, lengths=lengths, nbits=nbits,
                 digest=_stream_digest(data, lengths, nbits))
    os.replace(path + ".part", path)


def load_streams(path: str) -> Optional[List[Tuple[bytes, int]]]:
    """The streams save_streams wrote, or None where the file is missing
    or its content does not match its sha256."""
    try:
        with np.load(path) as z:
            data, lengths, nbits, digest = (z["data"], z["lengths"],
                                            z["nbits"], z["digest"])
    except (OSError, KeyError, ValueError, zipfile.BadZipFile):
        return None
    if not np.array_equal(_stream_digest(data, lengths, nbits), digest):
        return None
    ends = np.cumsum(lengths)
    return [(data[e - n:e].tobytes(), int(b))
            for e, n, b in zip(ends, lengths, nbits)]


def reference_digest() -> str:
    """sha256 of the sources that make the benchmark's inputs: the content
    and the reference.  A cached input of other sources is not read."""
    here = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha256()
    for path in [os.path.join(here, "content.py")] + sorted(
            glob.glob(os.path.join(here, "reference", "*.py"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


class Entry:
    """What the harness asks of an entry (see the module docstring).
    `cache_dir` is the benchmark's fixed directory in the checkout for
    inputs that set-up makes from the seed and may keep."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, log: Callable[[str], None],
                 cache_dir: str):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.log, self.cache_dir = device, log, cache_dir
        self.streams, self.frames = traffic["streams"], traffic["frames"]
        fmt = ref_constants.FORMATS[config["format"]]
        self.height, self.width, self.mbs = fmt.height, fmt.width, \
            fmt.num_mbs

    def content(self) -> Dict[str, torch.Tensor]:
        return make_content(self.height, self.width, self.streams,
                            self.frames, self.traffic["noise"], self.seed,
                            self.device)

    def shapes(self) -> dict:
        return dict(height=self.height, width=self.width,
                    search=self.config.get("search", 15),
                    streams=self.streams, frames=self.frames)


class BatchEncode(Entry):
    """`tools.batch_encode.encode_resilient` over one card: raw frames in
    host memory to per-stream (bytes, nbits), `chunk` streams per pipelined
    piece.  Every job encodes the same content; every job's bytes are kept
    and compared."""

    def setup(self) -> None:
        from p64tpu_torch.distrib import mesh
        self.cfg = port_config(self.config)
        self.mesh = mesh.make_mesh(devices=[self.device])
        t = time.perf_counter()
        self.batch = {k: v.cpu().numpy() for k, v in self.content().items()}
        self.log(f"content {time.perf_counter() - t:.3f} s")
        self.kept: List[list] = []
        t = time.perf_counter()
        self.job()
        self.log(f"warm-up job {time.perf_counter() - t:.3f} s")

    def job(self):
        from p64tpu_torch.tools.batch_encode import encode_resilient
        return encode_resilient(self.cfg, self.batch, self.mesh,
                                chunk=self.traffic["chunk"])

    def tally(self, result) -> Tuple[int, int, int]:
        """(attempted, failed, macroblocks returned) of a job."""
        done = sum(r is not None for r in result)
        return len(result), len(result) - done, done * self.frames * self.mbs

    def keep(self, result) -> None:
        self.kept.append(result)

    def replays_per_job(self) -> int:
        chunks = -(-self.streams // self.traffic["chunk"])
        return chunks * self.frames

    def shapes(self) -> dict:
        return dict(super().shapes(), launch_streams=min(
            self.traffic["chunk"], self.streams))

    def spans(self) -> Dict[str, List[float]]:
        """finalize: per job, host seconds from the chunks' encoded outputs
        on the card to their bytes: the copies to pinned host memory, the
        wait for them and the serialize, over outputs made beforehand."""
        from p64tpu_torch.core import encoder as enc
        from p64tpu_torch.distrib import mesh as dm
        chunk = self.traffic["chunk"]
        out = []
        for _ in range(self.traffic["span_jobs"]):
            outputs = []
            for s in range(0, self.streams, chunk):
                sub = {k: v[s:s + chunk] for k, v in self.batch.items()}
                n = sub["y"].shape[0]
                _, outs, _ = dm.make_sharded_encoder(self.cfg, self.mesh)(
                    dm.shard_batch(self.mesh, dm.init_states(self.cfg, n)),
                    dm.shard_batch(self.mesh, sub))
                outputs += outs
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            for o in outputs:
                host, event = enc.outputs_to_host(o)
                if event is not None:
                    event.synchronize()
                enc.serialize_streams(self.cfg, host)
            out.append(time.perf_counter() - t0)
            del outputs
        return {"finalize": out}

    def check(self) -> List[Check]:
        """Every kept job's every stream against the reference's bytes."""
        frames = {k: torch.from_numpy(v).to(self.device)
                  for k, v in self.batch.items()}
        want, _ = reference_encode(self.config, frames)
        del frames
        differ = sum(got != w for job in self.kept
                     for got, w in zip(job, want))
        return [("streams_differ", differ, 0)]

    def reference_job(self, precision: str) -> List[Tuple[bytes, int]]:
        frames = {k: torch.from_numpy(v).to(self.device)
                  for k, v in self.batch.items()}
        with ref_dct.precision(precision):
            got, _ = reference_encode(self.config, frames)
        return got


class BatchDecode(Entry):
    """Archive playback as `tools/batch_decode.py::main` runs it, without its
    file writes: the native parse fanned over threads, then one
    `decode_seq_batch` per group of streams of equal frame count, the
    planes returned to host memory.  The streams are the reference
    encoder's of the seeded content, made in set-up or read from the
    checkout's cache; its reconstruction, made again after the window, is
    the answer.  The planes of `keep_jobs` jobs drawn from the seed are
    kept and compared.

    A configuration may state one key more, read here alone: `"channel":
    {"bit_error_rate": p}` sends the streams over a line that flips bits
    (`channel.py`) after they are made or read from the cache, and the
    port then parses with its scan for start codes, as
    `tools/batch_decode.py -e` does.  The answer for a damaged stream is
    the reference's own resync decode of its damaged bytes
    (`reference/playback.py`), and where the reference has none
    (`reference/parse.py::refusal`) the port has to refuse the stream too.
    A stream the port refuses (a StreamError) is None in the job's result.
    Without a channel it counts as failed; with one, the check after the
    window holds the port's refusals to the reference's."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.channel = self.config.get("channel")
        self.bit_error_rate = (None if self.channel is None
                               else line.check(self.channel))

    def setup(self) -> None:
        from p64tpu_torch.native import load
        t = time.perf_counter()
        self.inputs, how = self._inputs()
        self.log(f"the reference's streams, {how}, "
                 f"{time.perf_counter() - t:.3f} s")
        self.datas = [d for d, _ in self.inputs]
        #: the streams the port refused in any job
        self.refused: set = set()
        if self.channel is not None:
            self.datas, flips = line.flip(self.inputs, self.bit_error_rate,
                                          self.seed)
            self.log(f"channel: bit error rate {self.bit_error_rate}, "
                     f"{sum(flips)} bits flipped over {len(flips)} "
                     f"streams; per stream {flips}")
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        self.rng = random.Random(self.seed)
        self.kept: List[list] = []
        self.seen = 0
        load()
        self.groups = 0
        t = time.perf_counter()
        self.job()
        self.log(f"warm-up job {time.perf_counter() - t:.3f} s, "
                 f"{self.group_count} groups of equal frame count, "
                 f"{self.groups} replays")

    def _clean_key(self) -> str:
        """The cache's key for the clean streams: every key of the
        configuration but the line, the mix's sizes, the seed, the device
        kind and the reference."""
        config = {k: v for k, v in self.config.items() if k != "channel"}
        return hashlib.sha256(json.dumps(
            [config, self.streams, self.frames, self.traffic["noise"],
             self.seed, self.device.type, reference_digest()],
            sort_keys=True).encode()).hexdigest()[:32]

    def _inputs(self) -> Tuple[List[Tuple[bytes, int]], str]:
        """The reference's streams of this seed's content, from the cache
        where it holds them for this configuration, mix, seed, device kind
        and reference; else made and kept there."""
        path = os.path.join(self.cache_dir, f"streams-{self._clean_key()}.npz")
        got = load_streams(path)
        if got is not None:
            return got, "cached"
        got, _ = reference_encode(self.config, self.content())
        save_streams(path, got)
        return got, "made"

    def _parse_one(self, data: bytes):
        from p64tpu_torch.core.decoder import parse_to_tensors
        from p64tpu_torch.entropy.parse import StreamError
        try:
            return (parse_to_tensors(data) if self.channel is None
                    else parse_to_tensors(data, resync=True))
        except StreamError:
            return None

    def _parse(self):
        from p64tpu_torch.utils import fan_map
        parsed = fan_map(self._parse_one, self.datas,
                         name="parse_to_tensors")
        groups: Dict[tuple, List[int]] = {}
        for i, got in enumerate(parsed):
            if got is not None:
                fmt, _, seq = got
                groups.setdefault((fmt, seq["levels8"].shape[0]),
                                  []).append(i)
        return parsed, groups

    def job(self):
        from p64tpu_torch.core.decoder import decode_seq_batch
        parsed, groups = self._parse()
        self.groups = sum(t for _, t in groups)
        self.group_count = len(groups)
        planes: List[Optional[tuple]] = [None] * len(parsed)
        for (fmt, _), idxs in groups.items():
            for i, p in zip(idxs, decode_seq_batch(
                    fmt, [parsed[i][2] for i in idxs], device=self.device)):
                planes[i] = p
        return planes

    def tally(self, result) -> Tuple[int, int, int]:
        done = [p for p in result if p is not None]
        mbs = sum(p[0].shape[0] for p in done) * self.mbs
        refused = {i for i, p in enumerate(result) if p is None}
        self.refused |= refused
        # over a line, a refusal is judged against the reference's (check)
        return (len(result), len(refused) if self.channel is None else 0,
                mbs)

    def keep(self, result) -> None:
        """A reservoir sample of keep_jobs jobs, drawn from the seed."""
        k = self.traffic["keep_jobs"]
        self.seen += 1
        if len(self.kept) < k:
            self.kept.append(result)
        else:
            j = self.rng.randrange(self.seen)
            if j < k:
                self.kept[j] = result

    def replays_per_job(self) -> int:
        return self.groups

    def spans(self) -> Dict[str, List[float]]:
        """parse: per job, host seconds of the fanned parse and the stack
        and copy of every group to the card."""
        from p64tpu_torch.core.decoder import stack_seqs
        out = []
        for _ in range(self.traffic["span_jobs"]):
            t0 = time.perf_counter()
            parsed, groups = self._parse()
            batches = [stack_seqs(fmt, [parsed[i][2] for i in idxs],
                                  self.device)
                       for (fmt, _), idxs in groups.items()]
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            out.append(time.perf_counter() - t0)
            del batches
        return {"parse": out}

    def _played(self) -> List[Optional[tuple]]:
        """The reference's resync decode of each damaged stream, or None
        where it refuses the stream."""
        return ref_playback.play(ref_playback.parse_streams(self.datas),
                                 self.device, REFERENCE_STREAMS)

    def check(self) -> List[Check]:
        """Every stream of every kept job against the answer: pixels that
        differ (a stream of the wrong shape counts all its pixels, and so
        does one answered where the answer is a refusal).  Without a
        channel the answer is the reference's reconstruction of its coded
        frames; with one, the reference's decode of the damaged bytes, with
        `streams_refused`, the streams the port refused, held to the number
        the reference refuses, and `refused_alone`, those of them that the
        reference decodes, to none.  The reference encodes
        the seed's content again, and its streams have to be the ones
        decoded."""
        keep = (() if self.channel is not None
                else ref_encoder.RECON_KEYS + ("frame_coded",))
        streams, recon = reference_encode(self.config, self.content(),
                                          keep=keep)
        if streams != self.inputs:
            raise AssertionError("the decoded streams are not the "
                                 "reference's of this seed")
        if self.channel is not None:
            played = self._played()

            def want(s):
                return played[s]
        else:
            def want(s):
                coded = recon["frame_coded"][s]
                return tuple(recon[key][s][coded]
                             for key in ref_encoder.RECON_KEYS)
        differ = sum(_pixels_off(got, want(s)) for job in self.kept
                     for s, got in enumerate(job))
        checks = [("pixels_differ", differ, 0)]
        if self.channel is not None:
            refused = {i for i, p in enumerate(played) if p is None}
            checks += [("streams_refused", len(self.refused), len(refused)),
                       ("refused_alone", len(self.refused - refused), 0)]
        return checks

    def reference_job(self, precision: str) -> List[tuple]:
        """The reference's planes of each stream at `precision`: of the
        coded frames, its reconstruction from the streams' symbols; with a
        channel, its decode of the damaged bytes."""
        if self.channel is not None:
            with ref_dct.precision(precision):
                return self._played()
        _, out = reference_encode(
            self.config, self.content(),
            keep=ref_serialize.SYMBOL_KEYS)
        fmt = reference_config(self.config).fmt
        planes: List[list] = [[], [], []]
        with ref_dct.precision(precision):
            for b in range(0, self.streams, REFERENCE_STREAMS):
                blk = {k: torch.from_numpy(v[b:b + REFERENCE_STREAMS]).to(
                    self.device) for k, v in out.items()}
                for acc, p in zip(planes, ref_decode.reconstruct_sequence(
                        fmt, blk)):
                    acc.append(p.cpu().numpy())
        y, cb, cr = (np.concatenate(p) for p in planes)
        coded = out["frame_coded"]
        return [(y[s][coded[s]], cb[s][coded[s]], cr[s][coded[s]])
                for s in range(self.streams)]


def _pixels_off(got: Optional[tuple], want: Optional[tuple]) -> int:
    """Pixels of one stream's planes off the answer's (all of a plane of
    another shape; all of the planes where one side has none)."""
    if want is None:
        return 0 if got is None else sum(p.size for p in got)
    if got is None:
        return sum(w.size for w in want)
    return sum(w.size if p.shape != w.shape
               else int(np.count_nonzero(p != w))
               for p, w in zip(got, want))


ENTRIES = {"batch_encode": BatchEncode, "batch_decode": BatchDecode}
