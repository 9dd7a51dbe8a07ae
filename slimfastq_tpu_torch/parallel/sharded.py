"""Window encode/decode of whole blocks (the JAX package's
parallel/sharded.py) in its single-card form: ``mesh=None`` codes a
window of blocks on one card, every stream once over the window
(pipeline_native.encode_prepared_blocks / decode_blocks_device, which
api.encode_fastq / decode_fastq run). Each block's bytes equal the block
coded alone, and the blocks come back in order.
"""

from __future__ import annotations

from ..config import CodecConfig
from ..pipeline_native import (decode_block_finish, decode_blocks_device,
                               encode_prepared_blocks)
from . import single_card


def encode_prepared_blocks_sharded(pres, cfg: CodecConfig, mesh,
                                   device) -> list:
    """EncodedBlocks of a window of prepared blocks
    (pipeline_native.prepare_block_fast outputs), in order."""
    single_card(mesh)
    return encode_prepared_blocks(pres, cfg, device) if pres else []


def decode_blocks_sharded(blocks, cfg: CodecConfig, mesh, device) -> list:
    """One bytes-like FASTQ part per container block of the window, in
    order."""
    single_card(mesh)
    return [decode_block_finish(inter, cfg)
            for inter in decode_blocks_device(blocks, cfg, device)]
