"""Each stream group's inputs made on the main thread inside a window's
encode (pipeline_native._window_jobs: uploads, and Kernel L's launch in
``sfq.encode.lane_layout``), ms per raw GB encoded, self time of both."""
from sfqbench import spans

NAMES = ("sfq.encode.inputs",
         "sfq.encode.lane_layout")


def read(run):
    s = spans.of(run)
    return None if s is None else s.self_ms_per_GB("encode", NAMES)
