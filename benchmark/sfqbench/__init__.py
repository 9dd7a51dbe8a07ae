"""The benchmark harness of slimfastq_tpu_torch: the manifest's cells,
the closed loop that times the program, the host-stage wrappers and the
device trace of a traced run, the byte counts of the rooflines, and the
checks that decide ``correct``."""
