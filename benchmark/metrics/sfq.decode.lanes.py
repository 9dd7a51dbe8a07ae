"""The host's lane work inside a window's decode: the aux lanes'
transposes, lens_decode, SEQ/QUAL's arguments and their runs within the
device budget (a device-memory query), flags_reorder, and at level 4 the
match flags; ms per raw GB decoded, self time."""
from sfqbench import spans

NAMES = ("sfq.decode.lanes",
         "sfq.decode.match_flags")


def read(run):
    s = spans.of(run)
    return None if s is None else s.self_ms_per_GB("decode", NAMES)
