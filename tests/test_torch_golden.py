"""The port decodes the JAX package's golden containers of formats v2-v5
(levels 1-4) to their source, byte for byte, paired as
tests/test_golden.py pairs them. The kernels' plain versions run on the
CPU; the format-v1 fixtures are in test_torch_golden_v1.py."""

import io
import os

import pytest
import torch

from slimfastq_tpu_torch import api, container

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")


def _read(name):
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("fmt", [2, 3, 4, 5])
@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_golden_decodes(fmt, level):
    sfq = _read(f"golden_v{fmt}_l{level}.sfq")
    cfg = container.read_header(io.BytesIO(sfq))
    assert (cfg.fmt, cfg.level) == (fmt, level)
    assert api.decode_fastq(sfq, device="cpu") == _read("golden_v2.fastq")
