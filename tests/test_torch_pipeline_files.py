"""The port's pure-Python pipeline (``use_native=False``) over files and
over a mesh: the resumed streaming encode and the streaming decode
(api.encode_file_streaming / decode_file_streaming), and the sharded
encode and decode (parallel.sharded) on CPU meshes, against the
sequential containers (which tests/test_torch_pipeline.py holds against
the JAX package's)."""

import io

import numpy as np
import torch

from slimfastq_tpu_torch import api, container
from slimfastq_tpu_torch.config import config_for_level
from slimfastq_tpu_torch.parallel import mesh as M
from slimfastq_tpu_torch.parallel import sharded
from slimfastq_tpu_torch.utils.synth import synth_fastq

torch.set_num_threads(1)


def test_python_streaming_resume_equals_whole(tmp_path):
    """encode_file_streaming(use_native=False): chunks that cut records,
    then a copy cut in its second block and resumed, give the whole-file
    container, and so does resuming the whole container; the streaming
    decode gives the input back."""
    data = synth_fastq(70, read_len=40, seed=8, var_len=True, n_rate=0.01)
    kw = dict(level=3, lanes=32, aux_lanes=8, block_records=30)
    whole = api.encode_fastq(data, device="cpu", **kw)
    src, dst, back = tmp_path / "in.fq", tmp_path / "o.sfq", tmp_path / "b"
    src.write_bytes(data)
    opts = dict(device="cpu", use_native=False, chunk_bytes=2000)
    api.encode_file_streaming(str(src), str(dst), **opts, **kw)
    assert dst.read_bytes() == whole
    offs = container.read_index(io.BytesIO(whole))
    dst.write_bytes(whole[: offs[1] + 50])
    api.encode_file_streaming(str(src), str(dst), resume=True, **opts,
                              **kw)
    assert dst.read_bytes() == whole
    # resumed once more with one chunk the input's exact size (its last
    # records carried past the read loop): every block is in the output
    # already, so it comes back unchanged
    api.encode_file_streaming(str(src), str(dst), resume=True,
                              **{**opts, "chunk_bytes": len(data)}, **kw)
    assert dst.read_bytes() == whole
    api.decode_file_streaming(str(dst), str(back), device="cpu",
                              use_native=False)
    assert back.read_bytes() == data


def test_python_sharded_equals_sequential():
    """encode_fastq_sharded / decode_fastq_sharded(use_native=False) on a
    one-entry and a two-entry CPU mesh give the sequential container and
    the input back; one block's qualities span more than 64 values (qual
    depth 7), so a stream's blocks split by geometry."""
    rng = np.random.default_rng(9)
    data = synth_fastq(120, read_len=40, seed=9, var_len=True, n_rate=0.01)
    recs = data.split(b"\n")
    for i in range(4 * 40 + 3, 4 * 80, 4):
        recs[i] = bytes(rng.integers(33, 110, len(recs[i])).astype(np.uint8))
    data = b"\n".join(recs)
    cfg = config_for_level(3, lanes=32, aux_lanes=8, block_records=40)
    want = api.encode_fastq(data, cfg=cfg, device="cpu")
    two = M.make_mesh(devices=["cpu"] * 2)
    for mesh in (M.make_mesh(devices=["cpu"]), two):
        assert sharded.encode_fastq_sharded(data, cfg, mesh=mesh,
                                            use_native=False) == want
    assert sharded.decode_fastq_sharded(want, mesh=two,
                                        use_native=False) == data
