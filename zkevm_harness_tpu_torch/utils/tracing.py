"""Lightweight tracing/metrics: stage spans, counters, proof-pipeline timing.

Nested spans with wall-clock durations, counters, an in-process registry, and
a JSON dump. Enabled via ZKTPU_TRACE=1 or `GLOBAL.enabled = True` (zero
overhead when disabled beyond a dict lookup). Spans measure host wall-clock;
set `Tracer.sync` to a callable such as `torch.cuda.synchronize` and each span
closes only after the device has finished the work queued inside it. For
kernel-level profiles use torch.profiler alongside.
"""

from __future__ import annotations

import contextlib
import json
import os
import resource
import time
from typing import Dict, List, Optional

import torch

from ..ops import cuda_kernels as ck


class Tracer:
    def __init__(self, enabled: Optional[bool] = None):
        self.enabled = (os.environ.get("ZKTPU_TRACE") == "1"
                        if enabled is None else enabled)
        self.spans: List[dict] = []
        self.counters: Dict[str, float] = {}
        self._stack: List[dict] = []
        # optional callable run before a span closes (e.g. a device
        # synchronise), so durations cover queued device work
        self.sync = None

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        if not self.enabled:
            yield self
            return
        rec = {"name": name, "start": time.time(), "children": [], **attrs}
        (self._stack[-1]["children"] if self._stack else self.spans).append(rec)
        self._stack.append(rec)
        try:
            yield self
        finally:
            if self.sync is not None:
                self.sync()
            rec["duration_s"] = round(time.time() - rec.pop("start"), 6)
            self._stack.pop()

    def count(self, name: str, value: float = 1):
        if self.enabled:
            self.counters[name] = self.counters.get(name, 0) + value

    def report(self) -> dict:
        return {"spans": self.spans, "counters": self.counters}

    def dump(self, path: Optional[str] = None) -> str:
        text = json.dumps(self.report(), indent=1)
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text

    def flat_durations(self) -> Dict[str, float]:
        out: Dict[str, float] = {}

        def walk(spans, prefix=""):
            for s in spans:
                key = prefix + s["name"]
                out[key] = out.get(key, 0) + s.get("duration_s", 0)
                walk(s["children"], key + "/")

        walk(self.spans)
        return out


GLOBAL = Tracer()


def span(name: str, **attrs):
    return GLOBAL.span(name, **attrs)


def count(name: str, value: float = 1):
    GLOBAL.count(name, value)


class Stopwatch:
    """Host seconds of the steps of one task, each closed after a
    synchronise of a CUDA device (so queued device work is inside it); the
    process's peak host RSS; the task's peak device memory and kernel
    launches on a CUDA device."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.out: Dict[str, float] = {}
        if self.cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        self.device = device
        self.launches = dict(ck.LAUNCHES)
        self.t = time.perf_counter()

    def lap(self, name: str):
        if self.cuda:
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.out[name + "_s"] = self.out.get(name + "_s", 0.0) + now - self.t
        self.t = now

    def done(self, **shape) -> Dict:
        """The task's record: `shape`, its steps' seconds, its process and
        that process's peak host RSS so far in bytes; on a CUDA device its
        peak memory and launches."""
        out = dict(shape, **self.out, pid=os.getpid(),
                   host_max_rss=resource.getrusage(
                       resource.RUSAGE_SELF).ru_maxrss * 1024)
        if self.cuda:
            out["max_memory_allocated"] = \
                torch.cuda.max_memory_allocated(self.device)
            out["launches"] = {k: ck.LAUNCHES[k]
                               - self.launches.get(k, 0)
                               for k in ck.LAUNCHES}
        return out
