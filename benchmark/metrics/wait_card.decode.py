"""The host's waits on the card in a decode: Kernel D's symbols brought
back (streams_torch.StreamSet.symbols) and the SEQ/QUAL decode with
Kernel U (streams_torch.decode_seq_qual_raw_blocks), ms per raw GB."""
STAGES = [("slimfastq_tpu_torch.ops.streams_torch", "StreamSet.symbols",
           "wait_card"),
          ("slimfastq_tpu_torch.ops.streams_torch",
           "decode_seq_qual_raw_blocks", "wait_card")]


def read(run):
    return run.stage_ms_per_GB("decode", ["wait_card"])
