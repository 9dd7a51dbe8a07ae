"""The main thread's waits on the prep pool's blocks (api's futures of
pipeline_native.prepare_block_fast), ms per raw GB encoded."""
WAITS = {"prepare_block_fast": "wait_prep"}


def read(run):
    return run.stage_ms_per_GB("encode", ["wait_prep"])
