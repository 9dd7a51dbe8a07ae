"""Seconds from the start of the process to the first timed call:
imports, the CUDA context, the kernels built or loaded, the cell's files
made and coded once each."""


def read(run):
    return run.setup_s
