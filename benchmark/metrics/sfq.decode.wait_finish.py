"""The main thread's waits on the finish pool's blocks, ms per raw GB
decoded, self time."""
from sfqbench import spans

NAMES = ("sfq.decode.wait_finish",)


def read(run):
    s = spans.of(run)
    return None if s is None else s.self_ms_per_GB("decode", NAMES)
