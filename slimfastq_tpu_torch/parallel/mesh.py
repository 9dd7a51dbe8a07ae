"""Batched multi-block coding (the JAX package's parallel/mesh.py) in its
single-card form: with ``mesh=None`` each function codes many blocks of a
stream, or SEQ and QUAL of many blocks, with one kernel launch per stream
over the blocks (streams_torch's ``*_blocks`` entries). Blocks of
different lengths share a launch: each block's CTA runs its own step
count, so no block is padded to another's, and its bytes are those of
the block coded alone. Blocks without a coded step give empty streams.
"""

from __future__ import annotations

from ..ops import streams_torch
from . import single_card


def encode_stream_blocks(kind: str, geom, mesh, syms_list, counts_list,
                         pos_list=None, reset_list=None, *, device):
    """Per block (payload, lens) of one host-modelled stream."""
    single_card(mesh)
    return streams_torch.encode_stream_blocks(
        kind, geom, syms_list, counts_list, device, pos_list, reset_list)


def encode_seq_qual_raw_blocks(sgeom_list, mesh, raw_list, counts_list,
                               qgeom_list, minq_list, seq_map, *, device):
    """Per block {"SEQ": (payload, lens), "QUAL": ...} from raw bytes."""
    single_card(mesh)
    return streams_torch.encode_seq_qual_raw_blocks(
        sgeom_list, raw_list, counts_list, qgeom_list, minq_list, seq_map,
        device)


def decode_seq_qual_raw_blocks(sgeom_list, mesh, pay_s, lens_s, pay_q,
                               lens_q, ll_list, counts_list, starts_list,
                               lengths_list, totals, qgeom_list, minq_list,
                               seq_map, *, device):
    """Per block (seq_bytes, qual_bytes), record-major."""
    single_card(mesh)
    return streams_torch.decode_seq_qual_raw_blocks(
        sgeom_list, pay_s, lens_s, pay_q, lens_q, ll_list, counts_list,
        starts_list, lengths_list, totals, qgeom_list, minq_list, seq_map,
        device)


def decode_stream_blocks(kind: str, geom, mesh, payload_list, lens_list,
                         counts_list, steps_list, pos_list=None,
                         reset_list=None, *, device):
    """Per block [steps, W] u8 symbols of one host-modelled stream."""
    single_card(mesh)
    return streams_torch.decode_stream_blocks(
        kind, geom, payload_list, lens_list, counts_list, steps_list, device,
        pos_list, reset_list)
