"""Percent of the decode calls' main-thread wall (``sfq.decode``) in no
span but the root and the device steps."""
from sfqbench import spans


def read(run):
    s = spans.of(run)
    return None if s is None else s.unspanned_pct("decode")
