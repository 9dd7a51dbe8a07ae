"""Top-level encode/decode API over whole FASTQ files.

Every entry point runs its device work on ``device``: CUDA unless the
caller passes ``device="cpu"``, which runs the kernels' plain PyTorch
versions (the tests' setting). There is no silent fallback: asking for
CUDA on a machine without a card raises.

Small blocks are coded in windows (``_batch_window``): each stream's
kernel launch takes every block of the window, so blocks that underfill
the card share it. A window also closes before the block that would take
its SEQ/QUAL streams past the card's byte budget
(streams_torch.device_budget), so long reads code a block at a time, and
the blocks prepared ahead stay within _PREP_BYTES of raw bytes.
``encode_file_streaming`` / ``decode_file_streaming``
run the same pipelines over a file in bounded memory; the encode can be
resumed after a crash. The pipelines code each window on a device step:
one card (``Card``) here, or a mesh of cards (parallel.sharded, the
``--sharded`` path). The bytes never depend on the window, the streaming
or the mesh: every container equals the JAX package's.

Two host-side reference paths give the same bytes. ``backend="oracle"``
codes every stream with the NumPy oracle (ops/streams_np, the normative
bit format) in place of the card (``Oracle``): no device is touched, for
small inputs and for bisecting a fault between the host and the kernels.
``use_native=False`` runs the pure-Python pipeline (pipeline.encode_block
/ decode_block, one block at a time) in place of the native one, its
streams coded one at a time on the card (streams_torch.DeviceBackend:
Kernels E and C, or D, per stream) or by the oracle. Neither is ever
chosen for the caller.
"""

from __future__ import annotations

import io
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import container, native
from .config import CodecConfig, config_for_level
from .ops import streams_np, streams_torch
from .parallel.mesh import fits
from .pipeline import decode_block, encode_block
from .pipeline_native import (block_span, decode_block_finish,
                              decode_block_oracle, decode_blocks_device,
                              device_bytes, encode_prepared_block_oracle,
                              encode_prepared_blocks, prepare_block_fast)
from .utils.fastq import FastqBatch, parse_fastq_bytes, serialize_fastq


# blocks of host work kept in flight beside the device in the staged
# encode/decode pipelines (2 overlaps host and device across block
# boundaries)
_PIPE_DEPTH = 2
# the most blocks a window takes: a window's coded streams (11 a level-4
# block with match trials) must fit one Kernel C launch (256 streams)
MAX_WINDOW = 16
# raw bytes of the blocks prepared ahead of the device (at least one): two
# long-read blocks of 65,536 x 16.5 kb (2.2 GB each) in flight, as the
# JAX package's depth of 2 keeps, where a count of blocks would hold a
# window's worth; 64k x 100 bp blocks (16 MB) stay bounded by the count
_PREP_BYTES = 6 << 30


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless told otherwise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the kernels' "
                "plain PyTorch versions")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _batch_window(cfg: CodecConfig, window: int | None = None) -> int:
    """Blocks a window codes at once. A block of W coder lanes runs one
    CTA per stream, 7 to 11 of the card's 132 SMs, so blocks coded one at
    a time leave most of the card idle; a window codes its blocks' CTAs
    side by side. The default, up to 8 blocks and 262,144 records a
    window, is the H100 window sweep's (PERF.md §6): at 16,384-record
    blocks a window of 8 decoded faster than 4 and encoded as fast, and
    at 65,536 a window of 4 gave the lowest walls of 1, 2 and 4 at levels
    3 and 4 (the JAX package's min(8, 65536 // block_records) codes a
    65,536-record block alone). ``window`` overrides it (1 codes every
    block alone), up to MAX_WINDOW."""
    if window is None:
        window = min(8, 262144 // max(cfg.block_records, 1))
    if int(window) > MAX_WINDOW:
        raise ValueError(f"window {window} exceeds {MAX_WINDOW} blocks")
    return max(1, int(window))


class Card:
    """One device as the pipelines' device step (parallel.sharded.Sharded
    is a mesh's; Oracle the NumPy oracle's): whether its blocks pack
    their lanes on the host, the blocks a window takes, each shard's
    device-byte budget (one shard here), and a window's encode and
    decode."""
    host_pack = False

    def __init__(self, dev: torch.device):
        self.dev = dev

    def window(self, cfg: CodecConfig, window: int | None) -> int:
        return _batch_window(cfg, window)

    def budgets(self) -> list:
        return [streams_torch.device_budget(self.dev)]

    def encode(self, pres, cfg: CodecConfig) -> list:
        return encode_prepared_blocks(pres, cfg, self.dev)

    def decode(self, blocks, cfg: CodecConfig) -> list:
        return decode_blocks_device(blocks, cfg, self.dev)


class Oracle:
    """The NumPy oracle as the pipelines' device step (``backend=
    "oracle"``): every block packed on the host and coded by
    ops/streams_np, one block at a time; no device is touched. NumPy
    steps every lane one bit at a time: for small inputs."""
    host_pack = True

    def window(self, cfg: CodecConfig, window: int | None) -> int:
        return 1

    def budgets(self) -> list:
        return [streams_torch.CPU_BUDGET]

    def encode(self, pres, cfg: CodecConfig) -> list:
        return [encode_prepared_block_oracle(pre, cfg) for pre in pres]

    def decode(self, blocks, cfg: CodecConfig) -> list:
        return [decode_block_oracle(blk, cfg) for blk in blocks]


def _check_backend(backend: str) -> None:
    if backend not in ("torch", "oracle"):
        raise ValueError(f"unknown backend {backend!r}: torch or oracle")


def _step(backend: str, device):
    """The native pipelines' device step: a Card on ``device``, or the
    Oracle (``device`` unused)."""
    _check_backend(backend)
    return Oracle() if backend == "oracle" else Card(resolve_device(device))


def _coder(backend: str, device):
    """The pure-Python pipeline's per-stream coder: a DeviceBackend on
    ``device``, or the NumPy oracle module (``device`` unused)."""
    _check_backend(backend)
    return streams_np if backend == "oracle" else \
        streams_torch.DeviceBackend(resolve_device(device))


def _encode_ranges(ranges, cfg: CodecConfig, step, window, emit) -> list:
    """Encode the record ranges (buf, idx, lo, hi) in order on the device
    step (a Card or a mesh's Sharded); emit(blk) for each block, in
    order, on a one-worker writer; returns emit's results.

    Three stages (prep || device || write): a prep pool keeps the next
    window's blocks of host modelling (C++/NumPy, releases the GIL) in
    flight ahead of the device, ``depth + window - 1`` in all and within
    _PREP_BYTES of raw bytes; the main thread codes each window on the
    step, a window closing before the block that would take a shard past
    its device budget; the writer overlaps container framing/CRC/IO with
    the next window's device work. FIFO submission to the one-worker
    writer keeps block order, so the container equals the serial one.
    Memory holds that many prepared blocks, whatever the file's size."""
    wb = step.window(cfg, window)
    ahead = _PIPE_DEPTH + wb - 1
    budgets = step.budgets()
    ranges = iter(ranges)
    results = []
    with native.pipeline_omp_cap(), \
            ThreadPoolExecutor(max_workers=_PIPE_DEPTH) as prep_ex, \
            ThreadPoolExecutor(max_workers=1) as write_ex:
        pfuts: deque = deque()  # (future, raw bytes)
        wfuts: deque = deque()
        nxt, held = None, 0  # the next range; raw bytes prepared ahead

        def fill():
            nonlocal nxt, held
            while len(pfuts) < ahead:
                nxt = nxt or next(ranges, None)
                if nxt is None:
                    return
                span = block_span(*nxt[1:])
                if pfuts and held + span > _PREP_BYTES:
                    return
                pfuts.append((prep_ex.submit(prepare_block_fast, *nxt, cfg,
                                             step.host_pack), span))
                held += span
                nxt = None
        fill()
        while pfuts:
            pres, sizes, spans = [], [], 0
            while pfuts and len(pres) < wb:
                pre = pfuts[0][0].result()
                need = device_bytes(pre, cfg)
                if pres and not fits(sizes + [need], budgets):
                    break
                pres.append(pre)
                sizes.append(need)
                spans += pfuts.popleft()[1]
                fill()
            for blk in step.encode(pres, cfg):
                wfuts.append(write_ex.submit(emit, blk))
            del pres
            held -= spans
            fill()
            while len(wfuts) > wb + 1:  # surface write errors promptly
                results.append(wfuts.popleft().result())
        results.extend(wf.result() for wf in wfuts)
    return results


def encode_fastq(data: bytes, cfg: CodecConfig | None = None,
                 level: int = 3, device=None, window: int | None = None,
                 backend: str = "torch", use_native: bool = True,
                 **overrides) -> bytes:
    cfg = cfg or config_for_level(level, **overrides)
    if not use_native:
        return encode_fastq_python(data, cfg, _coder(backend, device))
    return encode_fastq_on(data, cfg, _step(backend, device), window)


def _batch_slice(b: FastqBatch, lo: int, hi: int) -> FastqBatch:
    return FastqBatch(b.ids[lo:hi], b.seqs[lo:hi], b.pluses[lo:hi],
                      b.quals[lo:hi])


def encode_fastq_python(data: bytes, cfg: CodecConfig, coder) -> bytes:
    """encode_fastq on the pure-Python pipeline, one block at a time, each
    stream coded by ``coder`` (the oracle module or a DeviceBackend)."""
    out = io.BytesIO()
    container.write_header(out, cfg)
    batch = parse_fastq_bytes(data)
    offsets = [container.write_block(out, encode_block(
        _batch_slice(batch, lo, lo + cfg.block_records), cfg, backend=coder))
        for lo in range(0, max(len(batch), 1), cfg.block_records)]
    container.write_index(out, offsets)
    return out.getvalue()


def encode_fastq_on(data: bytes, cfg: CodecConfig, step, window) -> bytes:
    """encode_fastq on a device step (a Card or a mesh's Sharded)."""
    out = io.BytesIO()
    container.write_header(out, cfg)
    buf = np.frombuffer(data, dtype=np.uint8)
    idx, n = native.fastq_index(data)
    ranges = ((buf, idx, lo, min(lo + cfg.block_records, n))
              for lo in range(0, max(n, 1), cfg.block_records))
    offsets = _encode_ranges(ranges, cfg, step, window,
                             lambda blk: container.write_block(out, blk))
    container.write_index(out, offsets)
    return out.getvalue()


def _decode_blocks(f, cfg: CodecConfig, step, window, emit) -> None:
    """Decode the container blocks of ``f`` in order on the device step (a
    Card or a mesh's Sharded); emit(part) for each block's FASTQ bytes, in
    order.

    Three stages (read || device || finish): a one-worker reader
    prefetches the next block's container bytes while a window is on the
    device; up to _PIPE_DEPTH host finishes (ID chain decode + assembly,
    release the GIL) run behind the device, collected in order. Blocks
    are read one at a time (seek-based, container.iter_blocks), so memory
    holds a window and the finishes in flight, whatever the container's
    size."""
    wb = step.window(cfg, window)
    with native.pipeline_omp_cap(), \
            ThreadPoolExecutor(max_workers=_PIPE_DEPTH) as fin_ex, \
            ThreadPoolExecutor(max_workers=1) as read_ex:
        gen = container.iter_blocks(f, cfg)
        rfut = read_ex.submit(next, gen, None)
        futs: deque = deque()
        more = True
        while more:
            blocks = []
            while len(blocks) < wb:
                blk = rfut.result()
                if blk is None:
                    more = False
                    break
                rfut = read_ex.submit(next, gen, None)
                blocks.append(blk)
            for inter in step.decode(blocks, cfg):
                futs.append(fin_ex.submit(decode_block_finish, inter, cfg))
            while len(futs) > _PIPE_DEPTH:
                emit(futs.popleft().result())
        while futs:
            emit(futs.popleft().result())


def decode_fastq(data: bytes, device=None, window: int | None = None,
                 backend: str = "torch", use_native: bool = True) -> bytes:
    if not use_native:
        coder = _coder(backend, device)
        f = io.BytesIO(data)
        parts = []
        _decode_python(f, container.read_header(f), coder, parts.append)
        return b"".join(parts)
    return decode_fastq_on(data, _step(backend, device), window)


def _decode_python(f, cfg: CodecConfig, coder, emit) -> None:
    """The container blocks of ``f`` through the pure-Python pipeline, in
    order, one at a time; emit(part) for each block's FASTQ bytes."""
    for blk in container.iter_blocks(f, cfg):
        emit(serialize_fastq(decode_block(blk, cfg, backend=coder)))


def decode_fastq_on(data: bytes, step, window) -> bytes:
    """decode_fastq on a device step (a Card or a mesh's Sharded)."""
    f = io.BytesIO(data)
    cfg = container.read_header(f)
    parts = []
    _decode_blocks(f, cfg, step, window, parts.append)
    return b"".join(parts)


def encode_file(src: str, dst: str, level: int = 3, device=None,
                backend: str = "torch", use_native: bool = True,
                **overrides) -> None:
    with open(src, "rb") as f:
        data = f.read()
    enc = encode_fastq(data, level=level, device=device, backend=backend,
                       use_native=use_native, **overrides)
    with open(dst, "wb") as f:
        f.write(enc)


def _record_boundary(chunk: bytes) -> int:
    """Largest prefix of `chunk` ending on a 4-line record boundary."""
    nls = np.flatnonzero(np.frombuffer(chunk, dtype=np.uint8) == 10)
    keep_nl = (len(nls) // 4) * 4
    if keep_nl == 0:
        return 0
    return int(nls[keep_nl - 1]) + 1


def iter_block_ranges_native(src: str, cfg: CodecConfig,
                             chunk_bytes: int = 1 << 28):
    """Yield (buf, idx, lo, hi) record ranges whose block boundaries are
    identical to a whole-file encode, while reading `src` in bounded
    chunks: whole leftover records carry over between chunks as bytes."""
    carry = b""
    with open(src, "rb") as f:
        while True:
            chunk = carry + f.read(chunk_bytes)
            if not chunk:
                break
            eof = len(chunk) < len(carry) + chunk_bytes
            cut = len(chunk) if eof else _record_boundary(chunk)
            data, carry = chunk[:cut], chunk[cut:]
            if not data:
                if eof:
                    break
                continue
            buf = np.frombuffer(data, dtype=np.uint8)
            idx, n = native.fastq_index(data)
            full = (n // cfg.block_records) * cfg.block_records
            limit = n if eof else full
            for lo in range(0, limit, cfg.block_records):
                yield buf, idx, lo, min(lo + cfg.block_records, limit)
            if limit < n:
                start = int(idx["id_off"][limit]) - 1
                carry = data[start:] + carry
            if eof:
                break


def encode_file_streaming(src: str, dst: str, level: int = 3, device=None,
                          chunk_bytes: int = 1 << 28, resume: bool = False,
                          backend: str = "torch", use_native: bool = True,
                          **overrides) -> None:
    """Stream a large (100GB-class) FASTQ through the encoder with bounded
    memory: reads chunk_bytes at a time, encodes whole blocks (in windows,
    as encode_fastq does), appends them via the resumable
    container.Writer. With resume=True, continues an interrupted output
    file after its last complete block.

    Output is byte-identical to encode_fastq on the same data: block
    boundaries land on block_records multiples, which this function
    guarantees by carrying remainder records between chunks. Memory holds
    one chunk and the pipeline's prepared blocks (use_native=False: one
    chunk's parsed records and a block)."""
    cfg = config_for_level(level, **overrides)
    if not use_native:
        encode_file_python(src, dst, cfg, _coder(backend, device),
                           chunk_bytes, resume)
        return
    encode_file_on(src, dst, cfg, _step(backend, device), chunk_bytes, resume,
                   None)


def encode_file_python(src: str, dst: str, cfg: CodecConfig, coder,
                       chunk_bytes: int, resume: bool) -> None:
    """encode_file_streaming on the pure-Python pipeline: each chunk's
    whole records parsed (parse_fastq_bytes), the records short of a
    block carried to the next chunk, each block encoded and appended in
    turn; with ``resume`` the blocks the output holds are skipped and its
    own config holds."""
    skip_records = 0
    if resume:
        w, skip_records = container.Writer.resume(dst)
        cfg = w.cfg
    else:
        w = container.Writer.create(dst, cfg)
    carry = b""                      # partial-record bytes
    batch_carry: FastqBatch | None = None   # records short of a block
    seen = 0
    with open(src, "rb") as f:
        while True:
            chunk = carry + f.read(chunk_bytes)
            if not chunk:
                break
            eof = len(chunk) < len(carry) + chunk_bytes
            cut = len(chunk) if eof else _record_boundary(chunk)
            data, carry = chunk[:cut], chunk[cut:]
            if not data:
                if eof:
                    break
                continue
            batch = parse_fastq_bytes(data)
            if batch_carry is not None:
                batch = FastqBatch(batch_carry.ids + batch.ids,
                                   batch_carry.seqs + batch.seqs,
                                   batch_carry.pluses + batch.pluses,
                                   batch_carry.quals + batch.quals)
            n = len(batch)
            full = (n // cfg.block_records) * cfg.block_records
            limit = n if eof else full
            for lo in range(0, limit, cfg.block_records):
                hi = min(lo + cfg.block_records, limit)
                if seen + hi <= skip_records:
                    continue  # already in the resumed output
                w.append(encode_block(_batch_slice(batch, lo, hi), cfg,
                                      backend=coder))
            seen += limit
            batch_carry = _batch_slice(batch, limit, n) if limit < n else None
            if eof:
                break
    # the records left when the input ends on a chunk's edge: the last
    # block, unless the resumed output holds it already
    if batch_carry is not None and seen + len(batch_carry) > skip_records:
        w.append(encode_block(batch_carry, cfg, backend=coder))
    w.close()


def encode_file_on(src: str, dst: str, cfg: CodecConfig, step,
                   chunk_bytes: int, resume: bool, window) -> None:
    """encode_file_streaming on a device step (a Card or a mesh's
    Sharded); with ``resume`` the output's own config holds."""
    skip_records = 0
    if resume:
        w, skip_records = container.Writer.resume(dst)
        cfg = w.cfg
    else:
        w = container.Writer.create(dst, cfg)

    def todo():
        seen = 0
        for buf, idx, lo, hi in iter_block_ranges_native(src, cfg,
                                                         chunk_bytes):
            seen += hi - lo
            if seen > skip_records:  # else: already in the resumed output
                yield buf, idx, lo, hi
    _encode_ranges(todo(), cfg, step, window, w.append)
    w.close()


def decode_file_streaming(src: str, dst: str, device=None,
                          backend: str = "torch",
                          use_native: bool = True) -> None:
    """Bounded-memory decode of a 100GB-class container: blocks are read
    (seek-based, via the index and the v2 length prefixes), decoded and
    written in order, so memory holds a few blocks regardless of the
    container's size."""
    if not use_native:
        coder = _coder(backend, device)
        with open(src, "rb") as f, open(dst, "wb") as out:
            _decode_python(f, container.read_header(f), coder, out.write)
        return
    decode_file_on(src, dst, _step(backend, device), None)


def decode_file_on(src: str, dst: str, step, window) -> None:
    """decode_file_streaming on a device step (a Card or a mesh's
    Sharded)."""
    with open(src, "rb") as f, open(dst, "wb") as out:
        cfg = container.read_header(f)
        _decode_blocks(f, cfg, step, window, out.write)


def decode_file(src: str, dst: str, device=None, backend: str = "torch",
                use_native: bool = True) -> None:
    decode_file_streaming(src, dst, device=device, backend=backend,
                          use_native=use_native)
