"""slimfastq_tpu_torch: the lossless FASTQ codec on PyTorch and CUDA.

A port of the JAX package ``slimfastq_tpu`` (which stays the reference):
the same container format, byte for byte, with the lane coder (its
contexts built online from the symbols), the emission compaction, the
lane layout (pack with pos/reset) and the unpack as hand-written CUDA
kernels (csrc/), and their plain PyTorch versions on the CPU. Entry
points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .api import (decode_fastq, decode_file, encode_fastq,  # noqa: F401
                  encode_file)
from .config import CodecConfig, config_for_level  # noqa: F401
