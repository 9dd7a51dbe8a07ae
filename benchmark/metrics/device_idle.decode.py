"""Percent of the decode calls' wall in which no operation ran on the
card (averaged over the cards)."""


def read(run):
    return run.idle_pct("decode")
