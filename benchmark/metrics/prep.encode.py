"""Host modelling of each block (pipeline_native.prepare_block_fast, as
api calls it), summed over the prep pool's threads, ms per raw GB."""
STAGES = [("slimfastq_tpu_torch.api", "prepare_block_fast", "prep")]


def read(run):
    return run.stage_ms_per_GB("encode", ["prep"])
