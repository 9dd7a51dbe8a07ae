"""The host-pack path end to end on the CPU (the kernels' plain versions):
with the port's pipeline_native._MAX_SPAN lowered to 1 every block packs
SEQ and QUAL on the host and unpacks them there, as a block of 2 GiB and
more does; Kernel E codes each of its SEQ/QUAL streams in one launch.
The containers must equal the JAX package's at levels 1, 2 and 3 (level
4: tests/test_torch_longread_l4.py) and each package must decode the
other's. Level 1 keeps both of those streams' tables in shared memory on
the card."""

import pytest
import torch

from slimfastq_tpu import api as japi
from slimfastq_tpu.ops import streams_jax
from slimfastq_tpu.utils.synth import synth_fastq
from slimfastq_tpu_torch import api as tapi
from slimfastq_tpu_torch import native
from slimfastq_tpu_torch import pipeline_native as TPN
from slimfastq_tpu_torch.config import config_for_level
from slimfastq_tpu_torch.ops import coder_torch as CT
from slimfastq_tpu_torch.ops import streams_torch as ST

torch.set_num_threads(1)


@pytest.fixture
def forced(monkeypatch):
    """The host-pack path on every block; returns the calls of the path's
    pieces and, per SEQ/QUAL launch of Kernel E, its chunks against the
    longest of its blocks' streams."""
    monkeypatch.setattr(TPN, "_MAX_SPAN", 1)
    calls = {"host_jobs": 0, "lane_encode_blocks": 0, "unpack_lanes": 0}
    coded = calls["coded"] = []  # (kind, chunks coded, chunks of the stream)

    for mod, name in ((ST, "host_jobs"), (CT, "lane_encode_blocks"),
                      (native, "unpack_lanes")):
        def spy(*args, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] += 1
            out = _fn(*args, **kw)
            if _name == "lane_encode_blocks" and args[1] in ("qual", "seq"):
                coded.extend((args[1], o[1].shape[0], it.NC)
                             for it, o in zip(args[0], out))
            return out
        monkeypatch.setattr(mod, name, spy)
    return calls


def _round_trip(data: bytes, level: int, calls: dict, **kw) -> bytes:
    enc_t = tapi.encode_fastq(data, device="cpu", level=level, **kw)
    enc_j = japi.encode_fastq(data, level=level, backend=streams_jax, **kw)
    assert enc_t == enc_j
    assert japi.decode_fastq(enc_t, backend=streams_jax) == data
    assert tapi.decode_fastq(enc_j, device="cpu") == data
    assert all(calls.values()), calls  # the path, its coder, its unpack
    # every SEQ/QUAL stream in one launch, all of its chunks
    assert all(n == NC for _, n, NC in calls["coded"])
    return enc_t


@pytest.mark.parametrize("level", [1, 2, 3])
def test_host_pack_containers_identical_and_cross_decode(level, forced):
    """Two blocks (200 and 30 records, variable lengths, N bases) at 128
    lanes: the JAX package's container, and each decodes the other's;
    SEQ and QUAL both code through Kernel E from the host-packed lanes."""
    data = synth_fastq(230, read_len=50, seed=4, var_len=True, n_rate=0.01)
    _round_trip(data, level, forced, lanes=128, aux_lanes=16,
                block_records=200)
    assert {k for k, _, _ in forced["coded"]} == {"qual", "seq"}
    if level == 1:
        cfg = config_for_level(1)
        assert all(CT.table_in_smem(g) for g in (cfg.qual, cfg.seq))

