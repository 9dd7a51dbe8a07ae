"""Kernel L's step-input mode with Kernel U (lanes back to records), in
percent of their roofline over the decode calls."""
from sfqbench import roofline


def read(run):
    return roofline.share(run, "decode", ("lane_layout_kernel",
                                          "lane_unpack_kernel"),
                          roofline.lanes_unpack)
