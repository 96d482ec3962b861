"""The `device` pileup engine's window over raw BAM records: one C++ walk
with K9 in the middle (walk_host.cpp through ctypes).

`pileup_window_walk` runs a window of the `device` engine when its inputs
are raw sources (pileup/native.py's RawBam or RawBamStream), which
`cli.main_pileup` opens for it without -v when every input is a BAM. Three
steps, which engine.pileup_window times as `decode`, `count` and `emit`:
- `stage`: bt_walk_stage decodes the window's records straight into the
  datum arrays engine._pileup_window_fast makes (site offset, sample, stat,
  pass), in a reused host buffer (no per-read Python object);
- engine._device_counts, the count both walks share: the arrays staged as
  6 bytes a datum, one copy to the device, one launch of K9's fused entry
  (its plain version on the CPU), the counts back;
- bt_walk_emit: the VCF text from the counts, read in place, with the
  window's context sums of _meth_average.tsv.
The text and the sums are those of engine._pileup_window_fast on the same
records, and of the `native` engine (tests/test_torch_pileup_walk.py).

The library is built with native/__init__.py's flags into `_build/` beside
this file on first use (a few seconds of g++), and rebuilt when
walk_host.cpp or the pinned native/pileup_native.cpp it includes is newer.
"""
import ctypes as C
import os
import subprocess

import numpy as np

from . import engine
from .common import NCONTXTS, RefCache
from .native import RawBamStream, _confc

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "walk_host.cpp")
_SO = os.path.join(_DIR, "_build", "libbiscuit_walk.so")
_DEPS = (_SRC, os.path.join(os.path.dirname(_DIR), "native",
                            "pileup_native.cpp"))

_lib = None
_BUF = np.zeros(0, np.uint8)   # bt_walk_stage's data, grown as needed


def _stale() -> bool:
    return not os.path.exists(_SO) or any(
        os.path.getmtime(s) > os.path.getmtime(_SO) for s in _DEPS)


def _build() -> None:
    import fcntl
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    # one build at a time (fork pool workers may ask at once), renamed into
    # place: as native/__init__.py builds
    with open(_SO + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale():
            return
        tmp = f"{_SO}.{os.getpid()}.tmp"
        base = ["g++", "-O3", "-funroll-loops", "-std=c++20", "-shared",
                "-fPIC", "-o", tmp]
        r = subprocess.run(base[:2] + ["-march=native"] + base[2:] + [_SRC],
                           capture_output=True)
        if r.returncode != 0:
            subprocess.run(base + [_SRC], check=True)
        os.replace(tmp, _SO)


def lib() -> C.CDLL:
    global _lib
    if _lib is None:
        if _stale():
            _build()
        L = C.CDLL(_SO)
        P, i32, i64 = C.c_void_p, C.c_int32, C.c_int64
        L.bt_walk_stage.argtypes = [P, P, i64, i64, i64, i32, P, P, P, P, P,
                                    i64]
        L.bt_walk_stage.restype = i64
        L.bt_walk_emit.argtypes = [P, P, P, i64, i64, i64, i32, P, P, P, P,
                                   P, P, P]
        L.bt_walk_emit.restype = i32
        L.bt_walk_free.argtypes = [P]
        L.bt_walk_free.restype = None
        _lib = L
    return _lib


class _Records:
    """The raw records of one window, per sample, as the C++ entries take
    them (the bytes and offsets held here while they run)."""

    def __init__(self, rawbams, tid: int, beg: int, end: int):
        self.blobs, self.offs = [], []
        for rb in rawbams:
            if isinstance(rb, RawBamStream):
                blob, offs = rb.window_blob(tid, beg, end)
            else:
                blob = rb.data
                offs = np.ascontiguousarray(rb.window_offsets(tid, beg, end),
                                            np.int64)
            self.blobs.append(blob or b"\0")
            self.offs.append(offs)
        n = len(rawbams)
        self.datas = (C.c_void_p * n)(
            *[C.cast(C.c_char_p(b), C.c_void_p) for b in self.blobs])
        self.lens = np.array([len(b) if o.size else 0
                              for b, o in zip(self.blobs, self.offs)],
                             np.int64)
        self.offs_ptrs = (C.c_void_p * n)(
            *[o.ctypes.data_as(C.c_void_p) for o in self.offs])
        self.n_recs = np.array([len(o) for o in self.offs], np.int64)

    def args(self):
        return (self.datas, self.lens.ctypes.data, self.offs_ptrs,
                self.n_recs.ctypes.data)


def stage(rawbams, rs: RefCache, conf, tid: int, chrm: str, beg: int,
          end: int):
    """The window's data decoded as the arrays engine._pileup_window_fast
    hands engine._device_counts: the int32 site offsets from beg, the int32
    samples, the uint8 stats (base << 4 | meth) and the pass flags, views of
    a host buffer that the next call reuses."""
    global _BUF
    rs.fetch(chrm, beg - 100 if beg > 100 else 1, end + 100)
    recs = _Records(rawbams, tid, beg, end)
    confc = C.byref(_confc(conf))
    while True:
        cap = len(_BUF) // 10
        n = lib().bt_walk_stage(confc, rs.arr.ctypes.data, rs.seqlen, beg,
                                end, len(rawbams), *recs.args(),
                                _BUF.ctypes.data, cap)
        if n >= 0:
            break
        if n == np.iinfo(np.int64).min:
            raise RuntimeError("bt_walk_stage: a record held more data than "
                               "its reference span")
        _BUF = np.empty(-n * 10 * 5 // 4 + 10, np.uint8)  # the data's bound
    return (_BUF[:4 * cap].view(np.int32)[:n],
            _BUF[4 * cap:8 * cap].view(np.int32)[:n],
            _BUF[8 * cap:8 * cap + n], _BUF[9 * cap:9 * cap + n].view(bool))


def pileup_window_walk(rawbams, rs: RefCache, conf, tid: int, chrm: str,
                       beg: int, end: int, betasum_context, cnt_context,
                       device) -> str:
    """One [beg, end) window of the `device` engine over raw records: the
    VCF text, with the context sums of its sites added into
    betasum_context and cnt_context ([n_bams][NCONTXTS] lists). A window
    with no data launches no count."""
    data = stage(rawbams, rs, conf, tid, chrm, beg, end)
    if not len(data[0]):
        return ""
    n_bams = len(rawbams)
    cm, cb, dp = (np.ascontiguousarray(a, np.int64) for a in
                  engine._device_counts(*data, end - beg, n_bams, device))
    # the sums go on from the caller's, site by site, as plp_format adds them
    bs = np.array(betasum_context, np.float64).reshape(-1)
    cc = np.array(cnt_context, np.int64).reshape(-1)
    out_buf, out_len = C.c_void_p(), C.c_int64()
    L = lib()
    if L.bt_walk_emit(C.byref(_confc(conf)), chrm.encode(), rs.arr.ctypes.data,
                      rs.seqlen, beg, end, n_bams, cm.ctypes.data,
                      cb.ctypes.data, dp.ctypes.data, C.byref(out_buf),
                      C.byref(out_len), bs.ctypes.data, cc.ctypes.data) != 0:
        raise RuntimeError("bt_walk_emit: out of memory")
    try:
        text = C.string_at(out_buf, out_len.value).decode()
    finally:
        L.bt_walk_free(out_buf)
    for sid in range(n_bams):
        row = slice(sid * NCONTXTS, (sid + 1) * NCONTXTS)
        betasum_context[sid][:] = bs[row].tolist()
        cnt_context[sid][:] = cc[row].tolist()
    return text
