"""Sharded whole-file encode and decode: a window's blocks data-parallel
over a mesh of cards (the JAX package's parallel/sharded.py).

The whole-window unit splits a window's prepared blocks (or container
blocks) over the mesh (mesh.runs: contiguous runs, in mesh order), runs
each shard on its own host thread under its card
(pipeline_native.encode_prepared_blocks / decode_blocks_device: every
stream's Kernels E, D and C launched once over the shard's blocks), and
joins the results in block order. Level 4's match trials code inside
each shard's call, and a block of 2 GiB and more takes the host-pack path
there, as on one card. The shard threads run no native host prep, so no
two threads enter native.pipeline_omp_cap at once.

The file-level entry points run the api pipelines (prep ahead, a
one-worker writer, the decode's finish pool, streaming and ``resume``)
with ``Sharded`` as their device step: a window is api._batch_window's
blocks per shard times the mesh's size, closing before the block that
would take a shard past its card's byte budget. The bytes never depend
on the window or on the mesh: every container equals the sequential
api.encode_fastq's.

``use_native=False`` runs the JAX package's pure-Python sharded path: per
window of blocks, the pure-Python modelling (pipeline.stream_jobs) on the
host, then each stream batched over the window's blocks (grouped by
geometry) and coded over the mesh (the stream-level mesh forms, each
shard launching Kernels E and C, or D, on its own card), the match
trials per threshold likewise; on decode each block's LEN first, then
SEQ and QUAL over the mesh and the rest of the block through
pipeline.decode_block on the mesh's first device. Its streaming forms
stay native, as in the JAX package.
"""

from __future__ import annotations

import io
from dataclasses import replace

import numpy as np

from .. import api, container
from ..config import CodecConfig, config_for_level
from ..models.matcher import THRESHOLDS
from ..ops import streams_torch
from ..ops.streams_np import build_pos_reset
from ..pipeline import (MATCH_USED, QUAL_NODELTA, EncodedBlock,
                        EncodedStream, _lane_lengths_matrix, decode_block,
                        decode_block_lengths, stream_jobs, streams_for)
from ..pipeline_native import (decode_block_finish, decode_blocks_device,
                               encode_prepared_blocks)
from ..utils.fastq import parse_fastq_bytes, serialize_fastq
from . import mesh as pmesh
from .mesh import Mesh, budgets, make_mesh, map_blocks


def encode_prepared_blocks_sharded(pres, cfg: CodecConfig,
                                   mesh: Mesh | None, device=None) -> list:
    """EncodedBlocks of a window of prepared blocks
    (pipeline_native.prepare_block_fast outputs), in order: each shard's
    run on its card, or all of them on ``device`` with mesh=None."""
    if mesh is None:
        return encode_prepared_blocks(pres, cfg, device) if pres else []
    return map_blocks(mesh, len(pres), lambda idx, dev:
                      encode_prepared_blocks([pres[i] for i in idx], cfg,
                                             dev))


def decode_blocks_device_sharded(blocks, cfg: CodecConfig,
                                 mesh: Mesh | None, device=None) -> list:
    """decode_blocks_device over the mesh: per container block of the
    window its intermediate for decode_block_finish, in order."""
    if mesh is None:
        return decode_blocks_device(blocks, cfg, device)
    return map_blocks(mesh, len(blocks), lambda idx, dev:
                      decode_blocks_device([blocks[i] for i in idx], cfg,
                                           dev))


def decode_blocks_sharded(blocks, cfg: CodecConfig, mesh: Mesh | None,
                          device=None) -> list:
    """One bytes-like FASTQ part per container block of the window, in
    order."""
    return [decode_block_finish(inter, cfg) for inter in
            decode_blocks_device_sharded(blocks, cfg, mesh, device)]


def _default_window(mesh: Mesh, cfg: CodecConfig) -> int:
    """api._batch_window's blocks per shard (the H100 window sweep's
    rule), times the mesh's size."""
    return api._batch_window(cfg) * mesh.size


class Sharded:
    """A mesh as the api pipelines' device step (api.Card is one card's):
    the blocks a window takes, each shard's device-byte budget, and a
    window's encode and decode."""
    host_pack = False

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def window(self, cfg: CodecConfig, window: int | None) -> int:
        if window is None:
            return _default_window(self.mesh, cfg)
        if -(-int(window) // self.mesh.size) > api.MAX_WINDOW:
            raise ValueError(f"window {window} exceeds {api.MAX_WINDOW} "
                             "blocks a shard")
        return max(1, int(window))

    def budgets(self) -> list:
        return budgets(self.mesh)

    def encode(self, pres, cfg: CodecConfig) -> list:
        return encode_prepared_blocks_sharded(pres, cfg, self.mesh)

    def decode(self, blocks, cfg: CodecConfig) -> list:
        return decode_blocks_device_sharded(blocks, cfg, self.mesh)


def encode_fastq_sharded(data: bytes, cfg: CodecConfig, mesh=None,
                         window_blocks: int | None = None,
                         use_native: bool = True) -> bytes:
    """Encode a FASTQ buffer with each window's blocks sharded over the
    mesh (default: every card of the node). Byte-identical to the
    sequential api.encode_fastq with the same config; working memory
    beyond the input is a few windows of blocks. use_native=False: the
    pure-Python pipeline (module docstring)."""
    mesh = mesh or make_mesh()
    if use_native:
        return api.encode_fastq_on(data, cfg, Sharded(mesh), window_blocks)
    window = window_blocks or _default_window(mesh, cfg)
    batch = parse_fastq_bytes(data)
    n = len(batch)
    ranges = [(lo, min(lo + cfg.block_records, n))
              for lo in range(0, max(n, 1), cfg.block_records)]
    out = io.BytesIO()
    container.write_header(out, cfg)
    offsets = []
    for wlo in range(0, len(ranges), window):
        wr = ranges[wlo: wlo + window]
        all_jobs, metas, extras = [], [], []
        for lo, hi in wr:
            jobs, nb, minq, qd, extra = stream_jobs(
                api._batch_slice(batch, lo, hi), cfg)
            all_jobs.append(jobs)
            metas.append((nb, minq, qd))
            extras.append(extra)
        # each stream batched across the window's blocks, run over the
        # mesh (qual depth / v5 seq order can vary per block: grouped by
        # geometry)
        results: list[dict[str, EncodedStream]] = [dict() for _ in wr]
        for name in streams_for(cfg.fmt):
            _encode_stream_groups(name, all_jobs, results, mesh)
        flags = _python_match_trials(all_jobs, extras, results, mesh, cfg)
        for b, (nb, minq, qd) in enumerate(metas):
            if extras[b].get("qual_nodelta"):
                flags[b] |= QUAL_NODELTA
            blk = EncodedBlock(nb, minq, qd, results[b], flags=flags[b],
                               seq_order=extras[b]["seq_order"])
            offsets.append(container.write_block(out, blk))
    container.write_index(out, offsets)
    return out.getvalue()


def _encode_stream_groups(name, all_jobs, results, mesh: Mesh) -> None:
    """Batch one stream across blocks (grouped by geometry) and encode it
    over the mesh (mesh.encode_stream_blocks), filling results[b][name];
    a job may carry the match-span flags as a seventh item. A stream that
    codes no step gets the (W, 0) payload that coding zero steps
    gives."""
    kinds = [jb[name] for jb in all_jobs]
    kind = kinds[0][0]
    groups: dict[object, list[int]] = {}
    for b, (_k, g, *_rest) in enumerate(kinds):
        groups.setdefault(g, []).append(b)
    for g, idxs in groups.items():
        jobs = [kinds[b] for b in idxs]
        counts_l = [np.asarray(j[3]) for j in jobs]
        nonempty = [i for i, j in enumerate(jobs)
                    if j[2].shape[0] > 0 and (counts_l[i] > 0).any()]
        enc = pmesh.encode_stream_blocks(
            kind, g, mesh, *([jobs[i][k] if k < len(jobs[i]) else None
                              for i in nonempty] for k in (2, 3, 4, 5, 6)))
        it = iter(enc)
        for i, b in enumerate(idxs):
            if i in nonempty:
                payload, lens = next(it)
            else:
                W = jobs[i][2].shape[1]
                payload = np.zeros((W, 0), dtype=np.uint8)
                lens = np.zeros(W, dtype=np.int64)
            results[b][name] = EncodedStream(
                counts_l[i].astype(np.int64), lens, payload)


def _python_match_trials(all_jobs, extras, results, mesh: Mesh,
                         cfg) -> list:
    """v5 trial selection of the pure-Python sharded encode (the JAX
    package's _oracle_match_trials): per threshold the blocks' e-variant
    SEQ streams (with their match-span flags) and MATCH streams batched
    over the mesh; each block accepts exactly as
    pipeline.choose_match_variant does (plain SEQ first, then the trials
    in threshold order, a trial only when SEQ + MATCH is strictly
    smaller). Returns the blocks' flags."""
    B = len(all_jobs)
    flags = [0] * B
    if not any(extras[b]["match_trials"] for b in range(B)):
        return flags
    best_total = {b: int(np.asarray(results[b]["SEQ"].lane_lens).sum())
                  for b in range(B)}
    for t in THRESHOLDS:
        tb = [b for b in range(B)
              if any(tr[0] == t for tr in extras[b]["match_trials"])]
        if not tb:
            continue
        trial = {b: tr for b in tb for tr in extras[b]["match_trials"]
                 if tr[0] == t}
        jobs, coded = [], [dict() for _ in tb]
        for b in tb:
            kind, geom, _, counts, pos, reset = all_jobs[b]["SEQ"]
            _, sq_e, msyms, mcounts, mflag = trial[b]
            jobs.append({"SEQ": (kind, geom, sq_e, counts, pos, reset,
                                 mflag),
                         "MATCH": ("byte", cfg.bytes_, msyms, mcounts, None,
                                   None)})
        for name in ("SEQ", "MATCH"):
            _encode_stream_groups(name, jobs, coded, mesh)
        for i, b in enumerate(tb):
            seq, match = coded[i]["SEQ"], coded[i]["MATCH"]
            total = int(seq.lane_lens.sum()) + int(match.lane_lens.sum())
            if total < best_total[b]:
                best_total[b] = total
                flags[b] = MATCH_USED
                results[b]["SEQ"], results[b]["MATCH"] = seq, match
    return flags


def decode_fastq_sharded(data: bytes, mesh=None,
                         window_blocks: int | None = None,
                         use_native: bool = True) -> bytes:
    """Decode a container with each window's blocks sharded over the
    mesh; byte-identical to the sequential decode. use_native=False: the
    pure-Python pipeline (module docstring)."""
    mesh = mesh or make_mesh()
    if use_native:
        return api.decode_fastq_on(data, Sharded(mesh), window_blocks)
    f = io.BytesIO(data)
    cfg = container.read_header(f)
    window = window_blocks or _default_window(mesh, cfg)
    parts: list = []
    blocks: list = []
    for blk in container.iter_blocks(f, cfg):
        blocks.append(blk)
        if len(blocks) >= window:
            parts.extend(_decode_blocks_python(blocks, cfg, mesh))
            blocks = []
    parts.extend(_decode_blocks_python(blocks, cfg, mesh))
    return b"".join(parts)


class _Precomputed:
    """A per-stream backend for pipeline.decode_block that serves a
    block's SEQ and QUAL symbols decoded over the mesh and delegates the
    rest (the aux streams; the SEQ of a MATCH_USED block, whose
    match-span flags come from its own MATCH stream) to ``coder``."""

    def __init__(self, coder, seq_syms, qual_syms):
        self.coder = coder
        self.served = {"seq": seq_syms, "qual": qual_syms}

    def decode_stream(self, kind, geom, payload, lens, counts, num_steps,
                      pos=None, reset=None, mflag=None):
        if self.served.get(kind) is not None:
            return self.served[kind]
        return self.coder.decode_stream(kind, geom, payload, lens, counts,
                                        num_steps, pos=pos, reset=reset,
                                        mflag=mflag)


def _decode_blocks_python(blocks, cfg: CodecConfig, mesh: Mesh) -> list:
    """A window of container blocks through the pure-Python pipeline (the
    JAX package's _decode_blocks_oracle): each
    block's LEN decoded first (its lengths give the SEQ/QUAL lane layout),
    then QUAL, and SEQ of the blocks without MATCH_USED, over the mesh
    (grouped by geometry), then every block finished by
    pipeline.decode_block on the mesh's first device. One FASTQ part per
    block."""
    if not blocks:
        return []
    coder = streams_torch.DeviceBackend(mesh.devices[0])
    W = cfg.lanes
    counts_list, steps_list, pos_list, reset_list = [], [], [], []
    sgeoms, qgeoms = [], []
    for blk in blocks:
        lengths = decode_block_lengths(blk, cfg, backend=coder)
        ll = _lane_lengths_matrix(lengths, W)
        counts = ll.sum(axis=0)
        steps = int(counts.max()) if counts.size else 0
        pos, reset = build_pos_reset(ll, steps)
        counts_list.append(counts)
        steps_list.append(steps)
        pos_list.append(pos)
        reset_list.append(reset)
        qgeoms.append(replace(cfg.qual, depth=blk.qual_depth,
                              delta_bits=0 if (blk.flags & QUAL_NODELTA)
                              else cfg.qual.delta_bits))
        sgeoms.append(replace(cfg.seq, order=blk.seq_order)
                      if (cfg.fmt >= 5 and blk.seq_order) else cfg.seq)

    def grouped(kind, name, geoms, sel):
        groups: dict[object, list[int]] = {}
        for b in sel:
            groups.setdefault(geoms[b], []).append(b)
        dec: list = [None] * len(blocks)
        for g, idxs in groups.items():
            es = [blocks[b].streams[name] for b in idxs]
            res = pmesh.decode_stream_blocks(
                kind, g, mesh, [e.payload for e in es],
                [e.lane_lens for e in es], [counts_list[b] for b in idxs],
                [steps_list[b] for b in idxs], [pos_list[b] for b in idxs],
                [reset_list[b] for b in idxs])
            for b, r in zip(idxs, res):
                dec[b] = r
        return dec

    plain = [b for b, blk in enumerate(blocks)
             if not (cfg.fmt >= 5 and blk.flags & MATCH_USED)]
    seq = grouped("seq", "SEQ", sgeoms, plain)
    qual = grouped("qual", "QUAL", qgeoms, range(len(blocks)))
    return [serialize_fastq(decode_block(
        blk, cfg, backend=_Precomputed(coder, seq[b], qual[b])))
        for b, blk in enumerate(blocks)]


def encode_file_streaming_sharded(src: str, dst: str, level: int = 3,
                                  mesh=None, chunk_bytes: int = 1 << 28,
                                  window_blocks: int | None = None,
                                  resume: bool = False,
                                  **overrides) -> None:
    """api.encode_file_streaming with the windows sharded over the mesh
    (the ``--streaming --sharded`` path): bounded memory, resumable, the
    sequential bytes."""
    api.encode_file_on(src, dst, config_for_level(level, **overrides),
                       Sharded(mesh or make_mesh()), chunk_bytes, resume,
                       window_blocks)


def decode_file_streaming_sharded(src: str, dst: str, mesh=None,
                                  window_blocks: int | None = None) -> None:
    """api.decode_file_streaming with the windows sharded over the mesh
    (the ``-d --streaming --sharded`` path)."""
    api.decode_file_on(src, dst, Sharded(mesh or make_mesh()),
                       window_blocks)
