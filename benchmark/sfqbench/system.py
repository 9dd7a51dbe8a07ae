"""The system under test, slimfastq_tpu_torch, as a cell drives it: its
public entry points on one card, ``api.encode_fastq`` /
``api.decode_fastq`` (prep || device || write and read || device ||
finish). Only the configuration's level and block layout are passed;
the level sets the geometry, which the check holds to the
configuration's file."""

from __future__ import annotations


class System:
    def __init__(self, config: dict, chips: int, device: str = "cuda",
                 **overrides):
        import torch
        from slimfastq_tpu_torch import api
        if chips != 1:
            raise ValueError(f"a cell of {chips} chips: the harness drives "
                             "one card")
        kw = {k: config[k] for k in ("lanes", "aux_lanes", "block_records")}
        kw.update(overrides)
        level = config["level"]
        self.devices = [api.resolve_device(device)]
        self.encode = lambda data: api.encode_fastq(
            data, level=level, device=device, **kw)
        self.decode = lambda enc: api.decode_fastq(enc, device=device)
        self.cuda = [d for d in self.devices if d.type == "cuda"]
        self._torch = torch

    def sync(self) -> None:
        for d in self.cuda:
            self._torch.cuda.synchronize(d)

    def memory_peak_bytes(self) -> int:
        return max((self._torch.cuda.max_memory_allocated(d)
                    for d in self.cuda), default=0)
