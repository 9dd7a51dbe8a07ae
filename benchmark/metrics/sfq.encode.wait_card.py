"""The encode's waits on the card: Kernel E's overflow heads and Kernel
C's payloads brought to the host, ms per raw GB encoded, self time."""
from sfqbench import spans

NAMES = ("sfq.encode.wait_card",)


def read(run):
    s = spans.of(run)
    return None if s is None else s.self_ms_per_GB("encode", NAMES)
