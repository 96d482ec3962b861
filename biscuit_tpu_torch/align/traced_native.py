"""The C++ stage of the hybrid and `native` engines with its parts timed:
the port's batch entries of traced_host.cpp behind a NativeAligner.

`traced(engine, st)` gives the aligner that the hybrid and the `native`
engine run: `engine` if it is already a TracedAligner, else a
TracedAligner around `engine` (a NativeAligner) or a new NativeAligner.
`TracedAligner(nat)` runs NativeAligner's own `align_se_batch` and
`align_pe_batch` (the pinned copy's code) with itself as `self`, so that
the marshalling, the C++ call and the SAM's decoding run in the spans
`native.marshal`, `native.call` and `native.collect` (utils/spans.py), and
the call goes to `bt_port_align_se_batch` / `bt_port_align_pe_batch`,
which write the copy's SAM byte for byte. After each call the entry's
record is folded into the registry:
- spans `native.phase.<phase>` inside `native.call`: `regions+sam` (SE),
  `regions`, `pestat`, `pair` (PE) and `concat`;
- counters `native.busy_cpu` (thread-seconds inside the parallel phases'
  work-stealing loops), `native.busy.pair` (those of PE's `pair` phase),
  `native.threads` (the largest thread count), and while a torch.profiler
  records, `native.cpu.<slot>` (thread-seconds of the copy's profiler
  slots: seed, chain(+sa) with sa_walk inside it, chain_flt, extend,
  merge_regions, worker2(sam));
- counters `native.reads` (reads handed to the C++ engine) and
  `native.redo_reads` (those it handed back for Python to align again).
Every other attribute is the wrapped NativeAligner's, so its other
entries (worker1_batch and the region path) run the copy's library.

The library is built with native/__init__.py's flags (no PGO) into
`_build/` beside this file on first use (about 16 s of g++), and rebuilt
when one of its two C++ sources is newer.
"""
import ctypes
import os
import subprocess

import numpy as np

from .. import native
from ..utils import spans
from .native_engine import NativeAligner

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "traced_host.cpp")
_SO = os.path.join(_DIR, "_build", "libbiscuit_traced.so")
_DEPS = (_SRC, os.path.join(os.path.dirname(_DIR), "native", "align_host.cpp"))

# bt_trace_take's record (traced_host.cpp, TR_*)
TR_N = 23
PHASES = ("regions+sam", "regions", "pestat", "pair", "concat")
TR_BUSY, TR_THREADS, TR_SLOTS = 8, 15, 16
TR_PAIR = PHASES.index("pair")
SLOTS = ("seed", "chain(+sa)", "chain_flt", "extend", "merge_regions",
         "worker2(sam)", "sa_walk")

_lib = None


def _stale() -> bool:
    return not os.path.exists(_SO) or any(
        os.path.getmtime(s) > os.path.getmtime(_SO) for s in _DEPS)


def _build() -> None:
    import fcntl
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    # one build at a time, renamed into place: as native/__init__.py builds
    with open(_SO + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale():
            return
        tmp = f"{_SO}.{os.getpid()}.tmp"
        base = ["g++", "-O3", "-funroll-loops", "-std=c++20", "-shared",
                "-fPIC", "-o", tmp]
        tail = [_SRC, "-lpthread"]
        r = subprocess.run(base[:2] + ["-march=native"] + base[2:] + tail,
                           capture_output=True)
        if r.returncode != 0:
            subprocess.run(base + tail, check=True)
        os.replace(tmp, _SO)


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        if _stale():
            _build()
        L = ctypes.CDLL(_SO)
        copy = native.lib()
        L.bt_port_align_se_batch.argtypes = copy.bt_align_se_batch.argtypes
        L.bt_port_align_se_batch.restype = ctypes.c_int32
        L.bt_port_align_pe_batch.argtypes = copy.bt_align_pe_batch.argtypes
        L.bt_port_align_pe_batch.restype = ctypes.c_int32
        L.bt_buf_free.argtypes = [ctypes.c_void_p]
        L.bt_buf_free.restype = None
        L.bt_trace_set.argtypes = [ctypes.c_int32]
        L.bt_trace_set.restype = None
        L.bt_trace_take.argtypes = [ctypes.c_void_p]
        L.bt_trace_take.restype = ctypes.c_int32
        _lib = L
    return _lib


def take() -> np.ndarray:
    """The record of the calls since the last take (bt_trace_take)."""
    out = np.zeros(TR_N, np.int64)
    if lib().bt_trace_take(out.ctypes.data) != TR_N:
        raise RuntimeError("traced_host.cpp's record has another length")
    return out


def _fold(rec: np.ndarray) -> None:
    """A record into the registry."""
    rec = rec.tolist()
    for i, ph in enumerate(PHASES):
        if rec[i]:
            spans.add(f"native.phase.{ph}", rec[i] * 1e-9)
    if rec[TR_BUSY + TR_PAIR]:
        spans.count("native.busy.pair", rec[TR_BUSY + TR_PAIR] * 1e-9)
    spans.count("native.busy_cpu",
                sum(rec[TR_BUSY:TR_BUSY + len(PHASES)]) * 1e-9)
    if rec[TR_THREADS]:
        spans.peak("native.threads", int(rec[TR_THREADS]))
    for i, slot in enumerate(SLOTS):
        if rec[TR_SLOTS + i]:
            spans.count(f"native.cpu.{slot}", rec[TR_SLOTS + i] * 1e-9)


class _Entries:
    """The `lib` that NativeAligner's batch methods see: the port's
    entries under the copy's names, in the span `native.call`, and this
    library's bt_buf_free for their buffers."""

    def __init__(self, L: ctypes.CDLL):
        self._L = L
        self.bt_buf_free = L.bt_buf_free

    def _call(self, fn, args):
        self._L.bt_trace_set(1 if spans.profiling() else 0)
        with spans.span("native.call"):
            rc = fn(*args)
            _fold(take())
        return rc

    def bt_align_se_batch(self, *args):
        return self._call(self._L.bt_port_align_se_batch, args)

    def bt_align_pe_batch(self, *args):
        return self._call(self._L.bt_port_align_pe_batch, args)


class TracedAligner:
    """`nat` with its fused batch entries timed (the module's docstring)."""
    align_se_batch = NativeAligner.align_se_batch
    align_pe_batch = NativeAligner.align_pe_batch

    def __init__(self, nat: NativeAligner):
        self._nat = nat
        self.lib = _Entries(lib())

    def __getattr__(self, name):
        return getattr(self._nat, name)

    def _marshal_reads(self, seqs):
        with spans.span("native.marshal"):
            return self._nat._marshal_reads(seqs)

    def _collect_sams(self, out_buf, out_lens, status, n):
        spans.count("native.reads", n)
        spans.count("native.redo_reads", int(np.count_nonzero(status[:n])))
        with spans.span("native.collect"):
            return NativeAligner._collect_sams(self, out_buf, out_lens,
                                               status, n)


def traced(engine, st) -> TracedAligner:
    """The TracedAligner to run: `engine` itself if it is one, else one
    around `engine` if it is a NativeAligner, else around a new one."""
    if isinstance(engine, TracedAligner):
        return engine
    return TracedAligner(engine if isinstance(engine, NativeAligner)
                         else NativeAligner(st))
