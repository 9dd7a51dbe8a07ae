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

Not ported: the JAX package's oracle fallbacks for ``use_native=False``
(``_MeshBatch``, ``_encode_stream_groups``, ``_oracle_match_trials``,
``_decode_blocks_oracle``). The port's native host library is a required
build, so it has no such path.
"""

from __future__ import annotations

from .. import api
from ..config import CodecConfig, config_for_level
from ..pipeline_native import (decode_block_finish, decode_blocks_device,
                               encode_prepared_blocks)
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
                         window_blocks: int | None = None) -> bytes:
    """Encode a FASTQ buffer with each window's blocks sharded over the
    mesh (default: every card of the node). Byte-identical to the
    sequential api.encode_fastq with the same config; working memory
    beyond the input is a few windows of blocks."""
    return api.encode_fastq_on(data, cfg, Sharded(mesh or make_mesh()),
                               window_blocks)


def decode_fastq_sharded(data: bytes, mesh=None,
                         window_blocks: int | None = None) -> bytes:
    """Decode a container with each window's blocks sharded over the
    mesh; byte-identical to the sequential decode."""
    return api.decode_fastq_on(data, Sharded(mesh or make_mesh()),
                               window_blocks)


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
