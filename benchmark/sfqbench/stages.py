"""Host-stage clocks of a traced run, set from the benchmark's side by
module attribute (as the port's tools/profile_wall_torch.py does) and
taken off again when the run ends.

A metric file names what it reads: ``STAGES``, (module, attribute
path, stage) triples whose calls are timed on whatever thread makes them
(a call inside another of the same stage counts once), and ``WAITS``,
{name of a function the api's pools run: stage}, for the main thread's
waits on those futures. Each stage's seconds are summed over the window
by direction. In a profiled call each timed stage also marks the trace
(``stage.<name>``), so the device's idle gaps can be put down to what
the host was doing."""

from __future__ import annotations

import functools
import importlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor


# the module whose ThreadPoolExecutor makes the pools waited on
POOL_OWNER = "slimfastq_tpu_torch.api"


class Stages:
    def __init__(self, stages, waits: dict):
        self.targets = []
        for module, path, name in dict.fromkeys(map(tuple, stages)):
            owner = importlib.import_module(module)
            *parents, attr = path.split(".")
            for p in parents:
                owner = getattr(owner, p)
            self.targets.append((owner, attr, name))
        self.waits = dict(waits)
        self.pool_owner = importlib.import_module(POOL_OWNER)
        self.acc: dict = {}
        self.lock = threading.Lock()
        self.local = threading.local()
        self.saved: list = []

    def take(self) -> dict:
        with self.lock:
            out, self.acc = self.acc, {}
        return out

    def _add(self, name: str, dt: float) -> None:
        with self.lock:
            self.acc[name] = self.acc.get(name, 0.0) + dt

    def timed(self, name: str, fn, *a, **k):
        import torch
        active = getattr(self.local, "active", None)
        if active is None:
            active = self.local.active = set()
        if name in active:
            return fn(*a, **k)
        active.add(name)
        t = time.perf_counter()
        try:
            with torch.profiler.record_function("stage." + name):
                return fn(*a, **k)
        finally:
            self._add(name, time.perf_counter() - t)
            active.discard(name)

    def _wrap(self, real, name: str):
        @functools.wraps(real)
        def timed(*a, **k):
            return self.timed(name, real, *a, **k)
        return timed

    def __enter__(self):
        for owner, attr, name in self.targets:
            real = owner.__dict__[attr]
            self.saved.append((owner, attr, real))
            setattr(owner, attr, self._wrap(real, name))
        stages = self

        class Pool(ThreadPoolExecutor):
            def submit(self, fn, *a, **k):
                fut = super().submit(fn, *a, **k)
                wait = stages.waits.get(getattr(fn, "__name__", ""))
                if wait is not None:
                    real = fut.result
                    fut.result = lambda timeout=None: stages.timed(
                        wait, real, timeout)
                return fut
        self.saved.append((self.pool_owner, "ThreadPoolExecutor",
                           self.pool_owner.ThreadPoolExecutor))
        self.pool_owner.ThreadPoolExecutor = Pool
        return self

    def __exit__(self, *exc):
        while self.saved:
            owner, attr, real = self.saved.pop()
            setattr(owner, attr, real)
        return False
