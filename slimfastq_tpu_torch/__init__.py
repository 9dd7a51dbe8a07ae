"""slimfastq_tpu_torch: the lossless FASTQ codec on PyTorch and CUDA.

A port of the JAX package ``slimfastq_tpu`` (which stays the reference):
the same container format, byte for byte, with the lane coder and the
emission compaction as hand-written CUDA kernels (csrc/) and the
whole-array schedule, pack and unpack math as PyTorch tensor ops. Entry
points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .api import (decode_fastq, decode_file, encode_fastq,  # noqa: F401
                  encode_file)
from .config import CodecConfig, config_for_level  # noqa: F401
