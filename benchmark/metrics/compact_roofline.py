"""Kernel C (the coded lanes compacted for the copy to the host) in
percent of its roofline over the encode calls."""
from sfqbench import roofline


def read(run):
    return roofline.share(run, "encode", ("compact_streams_kernel",),
                          roofline.compact)
