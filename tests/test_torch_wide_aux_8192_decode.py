"""Past 4,096 lanes on the CPU: the port's level-3 container at
`aux_lanes` 8192 of the JAX package (its NumPy oracle) is decoded by the
port. 1,100 reads fill fewer lanes than the block has, so
empty lanes code too. The card codes and decodes these widths with
Kernels E and D (tests/test_torch_cuda.py, chip_smoke.py's
`wide_lanes`)."""

import torch

from slimfastq_tpu import api as japi
from slimfastq_tpu_torch import api as tapi
from slimfastq_tpu_torch.utils.synth import synth_fastq

torch.set_num_threads(1)


def test_aux_lanes_8192_level_3_decodes_the_reference():
    data = synth_fastq(1100, read_len=50, seed=0, var_len=False,
                       n_rate=0.0)
    kw = dict(level=3, aux_lanes=8192, block_records=4096)
    ref = japi.encode_fastq(data, **kw)
    assert tapi.decode_fastq(ref, device="cpu") == data
