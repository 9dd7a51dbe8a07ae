"""The decode's copies to the host and the waits for them (every
``.cpu()`` of Kernel D's symbols and of Kernel U's bytes), ms per raw
GB decoded, self time."""
from sfqbench import spans

NAMES = ("sfq.decode.wait_card",)


def read(run):
    s = spans.of(run)
    return None if s is None else s.self_ms_per_GB("decode", NAMES)
