"""The port decodes the JAX package's format-v1 golden containers (levels
1-4; legacy header, un-prefixed blocks, per-base SEQX exceptions, the
frozen LEVELS_V1 geometry) to their source, byte for byte, paired as
tests/test_golden.py pairs them."""

import io
import os

import pytest
import torch

from slimfastq_tpu_torch import api, container
from slimfastq_tpu_torch.config import LEVELS_V1

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")


def _read(name):
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_golden_v1_decodes(level):
    sfq = _read("golden_v1.sfq" if level == 2 else f"golden_v1_l{level}.sfq")
    cfg = container.read_header(io.BytesIO(sfq))
    assert (cfg.fmt, cfg.level) == (1, level)
    assert (cfg.qual, cfg.seq) == (LEVELS_V1[level].qual,
                                   LEVELS_V1[level].seq)
    assert api.decode_fastq(sfq, device="cpu") == _read("golden_v1.fastq")
