"""Top-level encode/decode API over whole FASTQ files.

Every entry point runs its device work on ``device``: CUDA unless the
caller passes ``device="cpu"``, which runs the kernels' plain PyTorch
versions (the tests' setting). There is no silent fallback: asking for
CUDA on a machine without a card raises.

Not ported yet: window batching of small blocks and streaming/resume
(later slices); see pipeline_native for the per-block limits.
"""

from __future__ import annotations

import io
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import container, native
from .config import CodecConfig, config_for_level
from .pipeline_native import (decode_block_device, decode_block_finish,
                              encode_prepared_block, prepare_block_fast)


# blocks of host work kept in flight beside the device in the staged
# encode/decode pipelines (2 overlaps host and device across block
# boundaries)
_PIPE_DEPTH = 2


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


def encode_fastq(data: bytes, cfg: CodecConfig | None = None,
                 level: int = 3, device=None, **overrides) -> bytes:
    dev = resolve_device(device)
    cfg = cfg or config_for_level(level, **overrides)
    out = io.BytesIO()
    container.write_header(out, cfg)
    buf = np.frombuffer(data, dtype=np.uint8)
    idx, n = native.fastq_index(data)
    ranges = [(lo, min(lo + cfg.block_records, n))
              for lo in range(0, max(n, 1), cfg.block_records)]
    # three-stage pipeline (prep || device || write): a prep pool keeps
    # _PIPE_DEPTH blocks of host modelling (C++/NumPy, releases the GIL)
    # in flight ahead of the device; the main thread codes blocks on the
    # device in order; a one-worker writer overlaps container framing/CRC
    # with the next block's device work. FIFO submission to the one-worker
    # writer keeps block order, so the container equals the serial one.
    with native.pipeline_omp_cap(), \
            ThreadPoolExecutor(max_workers=_PIPE_DEPTH) as prep_ex, \
            ThreadPoolExecutor(max_workers=1) as write_ex:
        pfuts = deque(prep_ex.submit(prepare_block_fast, buf, idx, *r, cfg)
                      for r in ranges[:_PIPE_DEPTH])
        nxt = len(pfuts)
        wfuts = []
        while pfuts:
            pre = pfuts.popleft().result()
            if nxt < len(ranges):
                pfuts.append(prep_ex.submit(prepare_block_fast, buf, idx,
                                            *ranges[nxt], cfg))
                nxt += 1
            blk = encode_prepared_block(pre, cfg, dev)
            wfuts.append(write_ex.submit(container.write_block, out, blk))
        offsets = [wf.result() for wf in wfuts]
    container.write_index(out, offsets)
    return out.getvalue()


def decode_fastq(data: bytes, device=None) -> bytes:
    dev = resolve_device(device)
    f = io.BytesIO(data)
    cfg = container.read_header(f)
    parts = []
    # three-stage pipeline (read || device || finish): a one-worker reader
    # prefetches block k+1's container bytes while block k is on the
    # device; up to _PIPE_DEPTH host finishes (ID chain decode +
    # assembly, release the GIL) run behind the device, collected in order
    with native.pipeline_omp_cap(), \
            ThreadPoolExecutor(max_workers=_PIPE_DEPTH) as fin_ex, \
            ThreadPoolExecutor(max_workers=1) as read_ex:
        gen = container.iter_blocks(f, cfg)
        rfut = read_ex.submit(next, gen, None)
        futs: deque = deque()
        while True:
            blk = rfut.result()
            if blk is None:
                break
            rfut = read_ex.submit(next, gen, None)
            inter = decode_block_device(blk, cfg, dev)
            futs.append(fin_ex.submit(decode_block_finish, inter, cfg))
            while len(futs) > _PIPE_DEPTH:
                parts.append(futs.popleft().result())
        while futs:
            parts.append(futs.popleft().result())
    return b"".join(parts)


def encode_file(src: str, dst: str, level: int = 3, device=None,
                **overrides) -> None:
    with open(src, "rb") as f:
        data = f.read()
    enc = encode_fastq(data, level=level, device=device, **overrides)
    with open(dst, "wb") as f:
        f.write(enc)


def decode_file(src: str, dst: str, device=None) -> None:
    with open(src, "rb") as f:
        data = f.read()
    dec = decode_fastq(data, device=device)
    with open(dst, "wb") as f:
        f.write(dec)
