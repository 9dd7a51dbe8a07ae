"""Raw FASTQ GB restored by every completed decode call of the window
over the summed walls of those calls."""
from sfqbench.loop import rate_GBps


def read(run):
    return rate_GBps(run.calls, "decode")
