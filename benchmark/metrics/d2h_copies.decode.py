"""Copies from the card to the host (``sfq.decode.wait_card`` spans) per
block decoded."""
from sfqbench import spans

NAME = "sfq.decode.wait_card"


def read(run):
    s = spans.of(run)
    return None if s is None else s.per_block("decode", NAME)
