"""Kernel E (all its phases) in percent of its roofline over the encode
calls: it is bound by its chains, so this reads well under 1%."""
from sfqbench import roofline

KERNELS = ("rows_kernel", "touch_kernel", "touch_count_kernel",
           "touch_insert_kernel", "touch_offsets_kernel",
           "touch_write_kernel", "touch_rid_kernel", "radix_hist_kernel",
           "radix_scatter_kernel", "scan_reduce_kernel", "scan_apply_kernel",
           "entry_scan_kernel", "gather_kernel", "lane_code_kernel")


def read(run):
    return roofline.share(run, "encode", KERNELS, roofline.coder_encode)
