"""The host's time in Kernel D's launches with their uploads
(``sfq.decode.<stream>.coder``) and Kernel L's and U's
(``sfq.decode.lane_layout``, ``unpack_pair``, ``unpack_lanes``), ms per
raw GB decoded, self time."""
from sfqbench import spans

NAMES = ("sfq.decode.*.coder",
         "sfq.decode.lane_layout",
         "sfq.decode.unpack_pair",
         "sfq.decode.unpack_lanes")


def read(run):
    s = spans.of(run)
    return None if s is None else s.self_ms_per_GB("decode", NAMES)
