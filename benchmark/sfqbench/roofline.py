"""What each kernel must move for the work a call did, worked out from
the shapes of the cell's own data and of the container's streams (the
records' lengths, each stream's symbol counts and coded lengths), so the
count is the same whatever implements the kernel: every input read
once and every output written once. A kernel's share of its roofline is
the least time those bytes take at the card's published memory rate
over the device time its launches took.

The arithmetic follows the byte bounds of the port's chip_smoke.py
(Kernel L's pair mode 79.4 MB and Kernel U's 26.7 MB on a block of
65,536 x 100 bp at 1,024 lanes), counted here without any buffer that
only one design keeps (Kernel E's chunk buffers, Kernel C's chunk
counts). Kernel D's bound there is a chain and barrier bound, not a
roofline, and is not used.
"""

from __future__ import annotations

import numpy as np

from reference import coder, container

# published memory rate of each card, bytes/s (NVIDIA data sheets)
PEAK_BYTES_PER_S = {"H100": 3.35e12}
FLUSH = coder.FLUSH_BYTES
LANE_KINDS = ("SEQ", "QUAL")  # the streams with pos and reset


def peak(device_name: str) -> float | None:
    for key, rate in PEAK_BYTES_PER_S.items():
        if key in device_name:
            return rate
    return None


def block_shapes(data: bytes, fastq: bytes, cfg: dict) -> list:
    """Each block's shapes: records, bases, the lane layout's rows and
    steps, and each stream's (lanes, steps, coded bytes, largest lane)."""
    from reference.check import fastq_records
    _, _, lens = fastq_records(fastq)
    BR, W, Wa = cfg["block_records"], cfg["lanes"], cfg["aux_lanes"]
    out = []
    for b, span in enumerate(container.blocks(data)):
        L = lens[b * BR:(b + 1) * BR]
        n = len(L)
        Rpl = -(-n // W)
        mat = np.zeros(Rpl * W, dtype=np.int64)
        mat[:n] = L
        lane = mat.reshape(Rpl, W).sum(axis=0)
        head = container.block_head(data, span)
        streams = {}
        for name, (counts, lens_, _) in container.block_streams(
                data, span).items():
            if name in LANE_KINDS:
                counts = lane
            elif name == "FLAG":
                counts = np.bincount(np.arange(n) % Wa, minlength=Wa) * 3
            active = int((counts > 0).sum())
            streams[name] = {
                "W": len(lens_), "Sp": coder.pad_steps(int(counts.max())),
                "coded": int(lens_.sum()) - FLUSH * active,
                "payload": int(lens_.sum()),
                "widest": max(int(lens_.max()) - FLUSH, 0)}
        out.append({"records": n, "bases": int(L.sum()), "Rpl": Rpl, "W": W,
                    "Sp": coder.pad_steps(int(lane.max())),
                    "match": bool(head["flags"] & container.MATCH_USED),
                    "streams": streams})
    return out


def lanes_pack(blk: dict) -> int:
    """Kernel L, pair mode: the block's bases and qualities and its
    offsets, lengths and map in; SEQ and QUAL u8 and pos and reset int32
    [Sp, W] out."""
    return 2 * blk["bases"] + 12 * blk["Rpl"] * blk["W"] + 256 \
        + 10 * blk["Sp"] * blk["W"]


def lanes_unpack(blk: dict) -> int:
    """Kernel L's step-input mode (lengths in, pos and reset out) and
    Kernel U (SEQ and QUAL lanes in, record-major bases and qualities
    out, with offsets and lengths and the map)."""
    return 4 * blk["Rpl"] * blk["W"] + 8 * blk["Sp"] * blk["W"] \
        + 4 * blk["bases"] + 8 * blk["records"] + 256


def _step_bytes(name: str, s: dict, blk: dict) -> int:
    per = 1 + (8 if name in LANE_KINDS else 0) \
        + (1 if name == "SEQ" and blk["match"] else 0)
    return per * s["Sp"] * s["W"]


def coder_encode(blk: dict) -> int:
    """Kernel E over every stream the block keeps: symbols (and pos,
    reset, match flags) and counts in, coded bytes and lengths out."""
    return sum(_step_bytes(k, s, blk) + 8 * s["W"] + s["coded"]
               for k, s in blk["streams"].items() if s["Sp"])


def coder_decode(blk: dict) -> int:
    """Kernel D over every stream: payload, lengths and counts (and pos,
    reset, match flags) in, symbols out."""
    return sum(_step_bytes(k, s, blk) + 8 * s["W"] + s["payload"]
               for k, s in blk["streams"].items() if s["Sp"])


def compact(blk: dict) -> int:
    """Kernel C: each stream's coded bytes in, its lanes' rows (padded
    to 16 bytes) and totals out."""
    return sum(s["coded"] + s["W"] * (-(-s["widest"] // 16) * 16)
               + 4 * s["W"] for s in blk["streams"].values() if s["Sp"])


def share(run, kind: str, kernels: tuple, nbytes) -> float | None:
    """Percent of the roofline: the bytes of every completed ``kind``
    call at the card's rate over the device seconds of ``kernels`` in
    those calls; None where they did not run."""
    rate = peak(run.device_name)
    secs = sum(c.trace["kernels"].get(k, 0.0) for c in run.traced(kind)
               for k in kernels)
    if rate is None or secs <= 0:
        return None
    total = sum(sum(nbytes(b) for b in run.shapes[c.file])
                for c in run.traced(kind))
    return 100.0 * total / rate / secs
