"""The port's bounded-memory streaming path on the CPU (the kernels' plain
versions): api.encode_file_streaming reads the input in chunks that cut
records, and its container must equal the whole-file encode (the port's
and the JAX package's) byte for byte; a truncated output resumed with
resume=True must equal the full one; api.decode_file_streaming /
decode_file read one block at a time and give the input back; the
empty input's containers (whole-file and streamed) are pinned; and the
CLI's --streaming, --streaming --resume and -d --streaming give the bytes
of the plain commands."""

import builtins
import hashlib
import io

import pytest
import torch

from slimfastq_tpu import api as japi
from slimfastq_tpu.ops import streams_jax
from slimfastq_tpu.utils.synth import synth_fastq
from slimfastq_tpu_torch import api as tapi
from slimfastq_tpu_torch import cli as tcli
from slimfastq_tpu_torch import container as tcontainer

torch.set_num_threads(1)

CFG = dict(lanes=64, aux_lanes=16, block_records=30)


@pytest.fixture(scope="module")
def data():
    return synth_fastq(70, read_len=30, seed=3, var_len=True, n_rate=0.005)


@pytest.fixture(scope="module")
def whole(data):
    return tapi.encode_fastq(data, device="cpu", level=3, **CFG)


@pytest.fixture
def src(tmp_path, data):
    p = tmp_path / "in.fastq"
    p.write_bytes(data)
    return p


def _streamed(src, dst, **kw):
    # 1,500-byte chunks cut records (a record is ~80 bytes)
    tapi.encode_file_streaming(str(src), str(dst), level=3, device="cpu",
                               chunk_bytes=1500, **CFG, **kw)
    return dst.read_bytes()


def test_streaming_encode_matches_whole_file(src, tmp_path, data, whole):
    got = _streamed(src, tmp_path / "out.sfq")
    assert got == whole
    assert got == japi.encode_fastq(data, level=3, backend=streams_jax,
                                    **CFG)


def test_streaming_resume_after_truncation(src, tmp_path, whole):
    """A crash mid-way through the third block (no index, half a block
    written): resume drops the partial block and encodes the rest."""
    offs = tcontainer.read_index(io.BytesIO(whole))
    dst = tmp_path / "out.sfq"
    dst.write_bytes(whole[: offs[2] + 40])
    assert _streamed(src, dst, resume=True) == whole


def test_streaming_decode_reads_one_block_at_a_time(tmp_path, monkeypatch,
                                                    data, whole):
    """decode_file_streaming and decode_file never read the container
    whole: the largest single read is below a block's share."""
    enc = tmp_path / "c.sfq"
    enc.write_bytes(whole)
    nblocks = len(tcontainer.read_index(io.BytesIO(whole)))
    assert nblocks == 3
    max_read = [0]

    class Spy(io.FileIO):
        def read(self, n=-1):
            b = super().read(n)
            max_read[0] = max(max_read[0], len(b))
            return b

    def spy_open(path, mode="r", *a, **k):
        if str(path) == str(enc):
            return Spy(str(path), "rb")
        return builtins.open(path, mode, *a, **k)

    monkeypatch.setattr(tapi, "open", spy_open, raising=False)
    out = tmp_path / "c.fastq"
    tapi.decode_file_streaming(str(enc), str(out), device="cpu")
    assert out.read_bytes() == data
    assert 0 < max_read[0] < len(whole) // 2, "read the whole container"
    max_read[0] = 0
    tapi.decode_file(str(enc), str(tmp_path / "d.fastq"), device="cpu")
    assert (tmp_path / "d.fastq").read_bytes() == data
    assert 0 < max_read[0] < len(whole) // 2


# SHA-256 of the empty input's containers at CFG, level 3: the whole-file
# encode codes one empty block, the streaming encode no block (both
# packages do so; the two decode to empty output)
EMPTY_WHOLE = (392, "a38b5287b120d015d84a80c68642495e"
                    "f933f0d4a7ac5c0044067c976560f853")
EMPTY_STREAMED = (51, "a48abab79a02ded3a7516aa3c707bf46"
                      "780bf936f379d7aca10fa40ce4807299")


def _pinned(enc: bytes, pin: tuple, blocks: int) -> None:
    assert (len(enc), hashlib.sha256(enc).hexdigest()) == pin
    assert len(tcontainer.read_index(io.BytesIO(enc))) == blocks
    assert tapi.decode_fastq(enc, device="cpu") == b""


def test_empty_input_whole_file_container_pinned():
    """encode_fastq of no records: one empty block, the JAX package's
    container, pinned so that a change is deliberate."""
    enc = tapi.encode_fastq(b"", device="cpu", level=3, **CFG)
    assert enc == japi.encode_fastq(b"", level=3, backend=streams_jax, **CFG)
    _pinned(enc, EMPTY_WHOLE, 1)


def test_empty_input_streaming_container_pinned(tmp_path):
    """encode_file_streaming of an empty file: no block (unlike the
    whole-file encode), the JAX package's container, pinned."""
    src = tmp_path / "empty.fastq"
    src.write_bytes(b"")
    tapi.encode_file_streaming(str(src), str(tmp_path / "t.sfq"), level=3,
                               device="cpu", **CFG)
    japi.encode_file_streaming(str(src), str(tmp_path / "j.sfq"), level=3,
                               backend=streams_jax, **CFG)
    enc = (tmp_path / "t.sfq").read_bytes()
    assert enc == (tmp_path / "j.sfq").read_bytes()
    _pinned(enc, EMPTY_STREAMED, 0)


def test_cli_streaming_equals_plain(tmp_path, capsys):
    """At the CLI's full width (1,024 lanes), two 20-record blocks."""
    data = synth_fastq(30, read_len=40, seed=8)
    src = tmp_path / "in.fastq"
    src.write_bytes(data)
    base = ["--device", "cpu", "--block-records", "20"]
    plain, stream = tmp_path / "p.sfq", tmp_path / "s.sfq"
    assert tcli.main([str(src), "-o", str(plain), *base]) == 0
    assert tcli.main([str(src), "-o", str(stream), "--streaming",
                      *base]) == 0
    full = plain.read_bytes()
    assert stream.read_bytes() == full
    assert tcli.main([str(src), "-o", str(stream), "--streaming",
                      *base]) == 2  # exists, no -f, no --resume
    assert "exists" in capsys.readouterr().err
    offs = tcontainer.read_index(io.BytesIO(full))
    stream.write_bytes(full[: offs[1]])
    assert tcli.main([str(src), "-o", str(stream), "--streaming",
                      "--resume", *base]) == 0
    assert stream.read_bytes() == full
    back = tmp_path / "back.fastq"
    assert tcli.main(["-d", str(stream), "-o", str(back), "--streaming",
                      "--device", "cpu"]) == 0
    assert back.read_bytes() == data
    back.unlink()
    assert tcli.main(["-d", str(stream), "-o", str(back), "--streaming",
                      "--sharded", "--device", "cpu"]) == 0
    assert back.read_bytes() == data
