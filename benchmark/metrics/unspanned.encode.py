"""Percent of the encode calls' main-thread wall (``sfq.encode``) in no
span but the root and the device steps: what the other metrics leave
unnamed."""
from sfqbench import spans


def read(run):
    s = spans.of(run)
    return None if s is None else s.unspanned_pct("encode")
