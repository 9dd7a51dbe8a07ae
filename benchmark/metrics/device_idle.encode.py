"""Percent of the encode calls' wall in which no operation ran on the
card (averaged over the cards): 100 x (1 - busy / wall)."""


def read(run):
    return run.idle_pct("encode")
