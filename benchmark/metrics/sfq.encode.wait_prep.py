"""The main thread's waits on the prep pool's blocks, ms per raw GB
encoded, self time."""
from sfqbench import spans

NAMES = ("sfq.encode.wait_prep",)


def read(run):
    s = spans.of(run)
    return None if s is None else s.self_ms_per_GB("encode", NAMES)
