"""Each block's finish on the host (pipeline_native.decode_block_finish:
the ID and LEN chains, the flush of the streams, FASTQ assembly),
summed over the finish pool's threads, ms per raw GB decoded."""
STAGES = [("slimfastq_tpu_torch.api", "decode_block_finish", "finish")]


def read(run):
    return run.stage_ms_per_GB("decode", ["finish"])
