"""Kernel D in percent of its roofline over the decode calls: it is
bound by its symbol-step chain, so this reads well under 1%."""
from sfqbench import roofline


def read(run):
    return roofline.share(run, "decode", ("lane_decode_kernel",
                                          "lane_decode_loop_kernel"),
                          roofline.coder_decode)
