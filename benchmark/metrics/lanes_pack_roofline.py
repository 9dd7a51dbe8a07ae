"""Kernel L in pair mode (raw bytes to SEQ/QUAL lanes with pos and
reset): the bytes it must move at the card's memory rate over its device
time, in percent, over the encode calls."""
from sfqbench import roofline


def read(run):
    return roofline.share(run, "encode", ("lane_layout_kernel",),
                          roofline.lanes_pack)
