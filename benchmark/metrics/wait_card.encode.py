"""The host's waits on the card in an encode: Kernel E's overflow heads
(streams_torch._heads) and Kernel C's payloads brought back
(streams_torch._to_host), ms per raw GB encoded."""
STAGES = [("slimfastq_tpu_torch.ops.streams_torch", "_heads", "wait_card"),
          ("slimfastq_tpu_torch.ops.streams_torch", "_to_host", "wait_card")]


def read(run):
    return run.stage_ms_per_GB("encode", ["wait_card"])
