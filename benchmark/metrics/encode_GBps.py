"""Raw FASTQ GB (10^9 B) of every completed encode call of the window
over the summed walls of those calls."""
from sfqbench.loop import rate_GBps


def read(run):
    return rate_GBps(run.calls, "encode")
