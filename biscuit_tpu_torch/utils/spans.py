"""The port's spans and counters: one registry, in this process, for the
align path's stages and their parts.

- `span(name)`: a block's wall seconds, summed under its name.
  `stage(name)` is a span that counts towards `stage_report()["total_s"]`:
  the engines' stages (seed, sa, chain_scan, chain, extend, cigar, worker2,
  rescue, inject, native), which never nest.
- `add(name, seconds)`: a span timed elsewhere (the C++ engine's phases).
- `count(name, n)` adds to a counter; `peak(name, v)` keeps the largest;
  `declare(*names)` makes counters that read 0 before they are counted and
  after each reset.

While a `torch.profiler` records, and only then, each span also enters
`torch.profiler.record_function("bt.<name>#<chunk>")`, which puts it
in the profiler's trace on the kernels' clock. The chunk is the first read
number of the chunk being aligned (`set_chunk`), so that every span of one
chunk carries one identifier; it rides in the name because the profiler's
Chrome trace does not export a record_function's `args`. A profiler
records the thread it was started in, and other threads only when made
with `experimental_config=_ExperimentalConfig(profile_all_threads=True)`:
without it the spans of the hybrid's SE injector thread reach this
registry and not the trace.

`stage_report()` and `reset_stages()` (re-exported by
align/device_engine.py) are the views the engines, the benchmark and the
tests read.
"""
import sys
import threading
import time
from typing import Dict

# guards the tables below: the hybrid's injector thread adds to them
_LOCK = threading.Lock()
# span name -> wall seconds
_SPANS: Dict[str, float] = {}
# the spans entered as stages, summed in total_s
_STAGES = set()
_COUNTS: Dict[str, float] = {}
_DECLARED = []
# spans that reset_stages() keeps: the process's set-up, timed once
SETUP = "setup."

_CHUNK = [0]


def declare(*names: str) -> None:
    """Counters present in every report, 0 until counted and after each
    reset."""
    with _LOCK:
        for k in names:
            if k not in _DECLARED:
                _DECLARED.append(k)
                _COUNTS.setdefault(k, 0)


def profiling() -> bool:
    """Whether a torch.profiler is recording in this process (never imports
    torch). Its flag is the process's: in a thread the profiler does not
    record, a span enters a record_function that leaves no event."""
    torch = sys.modules.get("torch")
    return torch is not None and (
        torch.autograd.profiler._is_profiler_enabled
        or torch.autograd._profiler_enabled())


def set_chunk(first_read: int) -> None:
    """The chunk the spans that follow belong to: its first read number."""
    _CHUNK[0] = int(first_read)


def _record(name: str, seconds: float, stage: bool) -> None:
    with _LOCK:
        _SPANS[name] = _SPANS.get(name, 0.0) + seconds
        if stage:
            _STAGES.add(name)


class span:
    __slots__ = ("name", "stage", "t0", "rf")

    def __init__(self, name: str, stage: bool = False):
        self.name = name
        self.stage = stage

    def __enter__(self):
        self.rf = None
        if profiling():
            import torch
            self.rf = torch.profiler.record_function(
                f"bt.{self.name}#{_CHUNK[0]}")
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _record(self.name, dt, self.stage)
        return False


def stage(name: str) -> span:
    return span(name, stage=True)


def add(name: str, seconds: float) -> None:
    """A span of `seconds` timed elsewhere."""
    _record(name, seconds, False)


def count(name: str, n=1) -> None:
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def peak(name: str, v) -> None:
    with _LOCK:
        _COUNTS[name] = max(_COUNTS.get(name, v), v)


def stage_report() -> Dict[str, float]:
    """Every span's wall seconds under its name, the stages' sum
    (`total_s`) and every counter."""
    with _LOCK:
        rep = dict(_SPANS)
        rep["total_s"] = sum(_SPANS.get(k, 0.0) for k in _STAGES)
        rep.update(_COUNTS)
    return rep


def reset_stages() -> None:
    """Clears every span but the set-up's, and every counter (the declared
    ones back to 0)."""
    with _LOCK:
        for k in [k for k in _SPANS if not k.startswith(SETUP)]:
            del _SPANS[k]
        _COUNTS.clear()
        _COUNTS.update(dict.fromkeys(_DECLARED, 0))
