"""The whole slice on the CPU: slimfastq_tpu_torch.api (the kernels' plain
versions) against slimfastq_tpu.api with the streams_jax backend.
Containers must be byte-identical and each package must decode the
other's; the geometry crosses over through config.from_reference."""

import dataclasses
import io

import pytest
import torch

from slimfastq_tpu import api as japi
from slimfastq_tpu import config as jconfig
from slimfastq_tpu.ops import streams_jax
from slimfastq_tpu.utils.synth import corpus, synth_fastq
from slimfastq_tpu_torch import api as tapi
from slimfastq_tpu_torch import cli as tcli
from slimfastq_tpu_torch import config as tconfig
from slimfastq_tpu_torch import container as tcontainer
from slimfastq_tpu_torch.models.matcher import MATCH_CHUNK
from slimfastq_tpu_torch.pipeline import MATCH_USED

torch.set_num_threads(1)

KW = dict(lanes=16, aux_lanes=8, block_records=128)


@pytest.fixture(scope="module")
def data():
    # one block, variable lengths, some N bases
    return synth_fastq(100, read_len=50, seed=11, var_len=True,
                       n_rate=0.01)


@pytest.mark.parametrize("level", [1, 2, 3])
def test_containers_identical_and_cross_decode(data, level):
    enc_t = tapi.encode_fastq(data, device="cpu", level=level, **KW)
    enc_j = japi.encode_fastq(data, level=level, backend=streams_jax, **KW)
    assert enc_t == enc_j
    assert japi.decode_fastq(enc_t, backend=streams_jax) == data
    assert tapi.decode_fastq(enc_j, device="cpu") == data


def test_empty_input():
    enc_t = tapi.encode_fastq(b"", device="cpu", **KW)
    assert enc_t == japi.encode_fastq(b"", backend=streams_jax, **KW)
    assert tapi.decode_fastq(enc_t, device="cpu") == b""


def test_from_reference_round_trips_every_level():
    for table in ("LEVELS", "LEVELS_V1"):
        for level, ref in getattr(jconfig, table).items():
            d = dataclasses.asdict(ref)
            port = tconfig.from_reference(d)
            assert port == getattr(tconfig, table)[level]
            assert dataclasses.asdict(port) == d
    ref = jconfig.config_for_level(3, lanes=32, aux_lanes=8)
    port = tconfig.from_reference(dataclasses.asdict(ref))
    assert (port.qual.table_size, port.seq.table_size) == \
        (ref.qual.table_size, ref.seq.table_size)


def test_default_device_is_cuda(data):
    """With no device argument the entry points run on CUDA, and raise
    where there is no card (no silent CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.encode_fastq(data, **KW)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.decode_fastq(b"")
    with pytest.raises(ValueError):
        tapi.resolve_device("meta")


def _block_flags(enc: bytes) -> list:
    f = io.BytesIO(enc)
    cfg = tcontainer.read_header(f)
    return [blk.flags for blk in tcontainer.iter_blocks(f, cfg)]


# one block above MATCH_CHUNK records, so level 4 runs the matcher
KW4 = dict(lanes=128, aux_lanes=16, block_records=1536)


def test_level4_match_containers_identical_and_cross_decode():
    """A coverage corpus whose block takes a match trial (MATCH_USED):
    the container equals the JAX package's and each decodes the other's."""
    data = corpus("novaseq", 1100, seed=0)
    enc_t = tapi.encode_fastq(data, device="cpu", level=4, **KW4)
    enc_j = japi.encode_fastq(data, level=4, backend=streams_jax, **KW4)
    assert enc_t == enc_j
    assert _block_flags(enc_t)[0] & MATCH_USED
    assert japi.decode_fastq(enc_t, backend=streams_jax) == data
    assert tapi.decode_fastq(enc_j, device="cpu") == data


def test_level4_without_matches():
    """A level-4 block above MATCH_CHUNK records where the matcher finds
    nothing (no shared genome): no trial, no MATCH_USED, the JAX
    package's container."""
    data = synth_fastq(MATCH_CHUNK + 76, read_len=20, seed=3,
                       coverage_like=False)
    enc_t = tapi.encode_fastq(data, device="cpu", level=4, **KW4)
    assert enc_t == japi.encode_fastq(data, level=4, backend=streams_jax,
                                      **KW4)
    assert not _block_flags(enc_t)[0] & MATCH_USED
    assert tapi.decode_fastq(enc_t, device="cpu") == data


def test_level4_window_with_match_trials():
    """Two blocks above MATCH_CHUNK records in one window, so the matcher
    runs inside it and a block takes a match trial (MATCH_USED): equal to
    the one-block-at-a-time container (which the tests above hold against
    the JAX package's); decodes in a window."""
    data = synth_fastq(2 * 1030, read_len=100, seed=5, n_rate=0.001)
    kw = dict(level=4, block_records=1030)  # the full width: 1,024 lanes
    bat = tapi.encode_fastq(data, device="cpu", **kw)
    assert _block_flags(bat)[0] & MATCH_USED
    assert bat == tapi.encode_fastq(data, device="cpu", window=1, **kw)
    assert tapi.decode_fastq(bat, device="cpu") == data


def test_cli_round_trip(tmp_path, capsys):
    """The CLI at its default geometry (1024 lanes) on a few reads."""
    data = synth_fastq(12, read_len=30, seed=5)
    src = tmp_path / "in.fastq"
    src.write_bytes(data)
    out = tmp_path / "a.sfq"
    back = tmp_path / "out.fastq"
    assert tcli.main([str(src), "-o", str(out), "-2", "--device", "cpu",
                      "--block-records", "12", "-v"]) == 0
    assert "ratio" in capsys.readouterr().err
    assert tcli.main(["-d", str(out), "-o", str(back), "--device",
                      "cpu"]) == 0
    assert back.read_bytes() == data
    assert tcli.main(["-d", str(out), "-o", str(back), "--device",
                      "cpu"]) == 2  # exists, no -f
    if not torch.cuda.is_available():  # --sharded never falls back to CPU
        assert tcli.main([str(src), "-o", str(out), "--sharded", "-f"]) == 1
        assert "sfq-torch: no CUDA device" in capsys.readouterr().err
    assert tcli.main([str(src), "-o", str(out), "--resume", "-f"]) == 2
    assert "--resume needs --streaming" in capsys.readouterr().err
    assert tcli.main([str(src), "--streaming", "--device", "cpu"]) == 2
    assert "-o output" in capsys.readouterr().err


def test_encode_decode_file(tmp_path):
    """Two blocks through the staged pipeline, via files."""
    data = synth_fastq(12, read_len=30, seed=6)
    src = tmp_path / "in.fastq"
    src.write_bytes(data)
    tapi.encode_file(str(src), str(tmp_path / "a.sfq"), level=1,
                     device="cpu", lanes=4, aux_lanes=4, block_records=8)
    tapi.decode_file(str(tmp_path / "a.sfq"), str(tmp_path / "b.fastq"),
                     device="cpu")
    assert (tmp_path / "b.fastq").read_bytes() == data
