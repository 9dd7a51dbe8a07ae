"""The main thread's waits on the finish pool's blocks (api's futures of
pipeline_native.decode_block_finish), ms per raw GB decoded."""
WAITS = {"decode_block_finish": "wait_finish"}


def read(run):
    return run.stage_ms_per_GB("decode", ["wait_finish"])
