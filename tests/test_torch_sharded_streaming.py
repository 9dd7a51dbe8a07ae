"""Bounded-memory streaming with the windows sharded over a mesh of 8 CPU
entries (the kernels' plain versions; the JAX package's
tests/test_sharded_streaming.py, ported): the streaming sharded container
equals the JAX package's sequential one, the windows stay within
``window_blocks``, a resume after a cut reproduces the bytes, the
streaming sharded decode round-trips, and ``sfq-torch --sharded`` (whole
file and streaming, both directions) is cmp-equal to ``sfq``."""

import pytest
import torch

from slimfastq_tpu import api as japi
from slimfastq_tpu.cli import main as jmain
from slimfastq_tpu.config import config_for_level as jconfig_for_level
from slimfastq_tpu.ops import streams_jax
from slimfastq_tpu.utils.synth import synth_fastq
from slimfastq_tpu_torch import cli as tcli
from slimfastq_tpu_torch.parallel import mesh as tmesh
from slimfastq_tpu_torch.parallel import sharded as tsharded

torch.set_num_threads(1)

CFG = dict(lanes=64, aux_lanes=16, block_records=64)


@pytest.fixture(scope="module")
def mesh8():
    return tmesh.make_mesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def data():
    # 5 blocks, the last ragged; N runs and variable lengths
    return synth_fastq(64 * 4 + 17, read_len=40, seed=3, var_len=True,
                       n_rate=0.01)


@pytest.fixture(scope="module")
def sequential(data):
    return japi.encode_fastq(data, cfg=jconfig_for_level(2, **CFG),
                             backend=streams_jax)


def test_streaming_sharded_encode_bytes_and_window(tmp_path, data,
                                                   sequential, mesh8,
                                                   monkeypatch):
    """Windows of at most 3 blocks (the spy), read in 4 KB chunks whose
    records carry over: the sequential bytes."""
    src = tmp_path / "in.fastq"
    src.write_bytes(data)
    dst = tmp_path / "out.sfq"
    window_sizes = []
    real = tsharded.encode_prepared_blocks_sharded

    def spy(pres, cfg, mesh):
        window_sizes.append(len(pres))
        return real(pres, cfg, mesh)

    monkeypatch.setattr(tsharded, "encode_prepared_blocks_sharded", spy)
    tsharded.encode_file_streaming_sharded(
        str(src), str(dst), level=2, mesh=mesh8, chunk_bytes=1 << 12,
        window_blocks=3, **CFG)
    assert dst.read_bytes() == sequential
    assert window_sizes and max(window_sizes) <= 3, window_sizes
    assert sum(window_sizes) == 5


def test_streaming_sharded_resume(tmp_path, data, sequential, mesh8):
    """An output cut mid-block (index and tail gone) and resumed on the
    mesh: the sequential bytes."""
    src = tmp_path / "in.fastq"
    src.write_bytes(data)
    dst = tmp_path / "part.sfq"
    dst.write_bytes(sequential[: int(len(sequential) * 0.55)])
    tsharded.encode_file_streaming_sharded(
        str(src), str(dst), level=2, mesh=mesh8, window_blocks=2,
        resume=True)
    assert dst.read_bytes() == sequential


def test_streaming_sharded_decode_roundtrip(tmp_path, data, sequential,
                                            mesh8):
    enc = tmp_path / "in.sfq"
    enc.write_bytes(sequential)
    out = tmp_path / "out.fastq"
    tsharded.decode_file_streaming_sharded(str(enc), str(out), mesh=mesh8,
                                           window_blocks=3)
    assert out.read_bytes() == data


def test_cli_sharded_four_ways(tmp_path, capsys):
    """sfq-torch --sharded --device cpu (a one-entry CPU mesh), whole file
    and --streaming, encode and -d: cmp-equal to sfq's container and to
    the input. Without a card and without --device cpu it exits 1 with an
    sfq-torch message, and never codes on the CPU instead."""
    src = tmp_path / "in.fastq"
    src.write_bytes(synth_fastq(30, read_len=40, seed=8, var_len=True))
    base = ["--block-records", "20", "-f"]
    ref = tmp_path / "j.sfq"
    assert jmain([str(src), "-o", str(ref), *base]) == 0
    cpu = ["--sharded", "--device", "cpu", *base]
    for i, extra in enumerate(([], ["--streaming"])):
        enc, back = tmp_path / f"t{i}.sfq", tmp_path / f"t{i}.fastq"
        assert tcli.main([str(src), "-o", str(enc), *cpu, *extra]) == 0
        assert enc.read_bytes() == ref.read_bytes()
        assert tcli.main(["-d", str(enc), "-o", str(back), *cpu,
                          *extra]) == 0
        assert back.read_bytes() == src.read_bytes()
    if not torch.cuda.is_available():
        for extra in ([], ["--streaming"]):
            capsys.readouterr()
            assert tcli.main([str(src), "-o", str(tmp_path / "x.sfq"),
                              "--sharded", *base, *extra]) == 1
            assert "sfq-torch: no CUDA device" in capsys.readouterr().err
