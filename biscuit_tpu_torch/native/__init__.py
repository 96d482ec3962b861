"""ctypes loader for the port's native (C++) index construction code.

Compiles lazily with g++ on first use; the shared object is cached in
`_build/` next to the sources and rebuilt when a source is newer. This is
host C++ (suffix array, BWT), not a device kernel.

Copy of biscuit_tpu/native/__init__.py for the two sources that
index/build.py calls, sais.cpp (suffix_array, bwt_from_sa) and bwt_merge.cpp
(bwt_merge): `_declare` holds only their functions, and the PGO
and sanitizer builds of the source are left out. The rest is the source's
code; tests/test_torch_engine.py holds the copy to it.
"""
import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "_build", "libbiscuit_native.so")
_SOURCES = [os.path.join(_DIR, f) for f in sorted(os.listdir(_DIR)) if f.endswith(".cpp")]

_lib = None


def _build() -> None:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    # built under a process-private name and renamed: a concurrent process
    # never loads a torn file
    tmp = f"{_SO}.{os.getpid()}.tmp"
    base = ["g++", "-O3", "-funroll-loops", "-std=c++17", "-shared", "-fPIC",
            "-o", tmp]
    tail = _SOURCES + ["-lpthread"]
    # -march=native where the compiler takes it, else the portable build
    r = subprocess.run(base[:2] + ["-march=native"] + base[2:] + tail,
                       capture_output=True)
    if r.returncode != 0:
        subprocess.run(base + tail, check=True)
    os.replace(tmp, _SO)


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        stale = not os.path.exists(_SO) or any(
            os.path.getmtime(src) > os.path.getmtime(_SO)
            for src in _SOURCES + [os.path.join(_DIR, "__init__.py")]
        )
        if stale:
            _build()
        _lib = ctypes.CDLL(_SO)
        _declare(_lib)
    return _lib


def _declare(L: ctypes.CDLL) -> None:
    """argtypes/restype of every export: without argtypes ctypes passes a
    bare Python int as a 32-bit c_int and cuts an int64_t argument."""
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    L.sais_u8_i32.argtypes = [u8p, i32p, ctypes.c_int32, ctypes.c_int32]
    L.sais_u8_i32.restype = ctypes.c_int
    L.sais_u8_i64.argtypes = [u8p, i64p, ctypes.c_int64, ctypes.c_int64]
    L.sais_u8_i64.restype = ctypes.c_int
    L.bwt_from_sa_i64.argtypes = [u8p, i64p, u8p, ctypes.c_int64]
    L.bwt_from_sa_i64.restype = ctypes.c_int64
    L.bwt_from_sa_i32.argtypes = [u8p, i32p, u8p, ctypes.c_int64]
    L.bwt_from_sa_i32.restype = ctypes.c_int64
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    L.bwt_merge_build.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                  u32p, u64p, ctypes.c_int64, i64p]
    L.bwt_merge_build.restype = ctypes.c_int64


def _sa_alloc(n: int, dtype) -> np.ndarray:
    """Allocate the SA working array. With BISCUIT_TPU_SA_TMP=dir set, back
    it with a disk file (np.memmap) so human-scale builds (int64 SA of a
    6.2 G-char strand = ~50 GB) keep bounded resident memory: SA-IS touches
    the SA mostly through sequential bucket scans, which the page cache
    handles; the file is deleted as soon as the array is mapped."""
    d = os.environ.get("BISCUIT_TPU_SA_TMP")
    if not d:
        return np.empty(n, dtype=dtype)
    import tempfile
    fd, path = tempfile.mkstemp(prefix="btsa_", suffix=".bin", dir=d)
    os.close(fd)
    mm = np.memmap(path, dtype=dtype, mode="w+", shape=(n,))
    os.unlink(path)  # space reclaimed when the mapping closes
    return mm


def suffix_array(text: np.ndarray, alphabet_size: int = 4) -> np.ndarray:
    """Suffix array of a uint8 text (no sentinel; virtual $ is smallest).
    Uses the int32 SA-IS when the text fits (half the memory traffic) and
    returns the narrow dtype as-is — consumers accept either width."""
    text = np.ascontiguousarray(text, dtype=np.uint8)
    n = len(text)
    if n < (1 << 31) - 16:
        sa32 = _sa_alloc(n, np.int32)
        rc = lib().sais_u8_i32(text, sa32, n, alphabet_size)
        if rc != 0:
            raise RuntimeError(f"sais failed rc={rc}")
        return sa32
    sa = _sa_alloc(n, np.int64)
    rc = lib().sais_u8_i64(text, sa, n, alphabet_size)
    if rc != 0:
        raise RuntimeError(f"sais failed rc={rc}")
    return sa


def bwt_merge(text: np.ndarray, sa_intv: int, block_size: int | None = None):
    """Blockwise semi-external BWT construction (native/bwt_merge.cpp):
    returns (words uint32, occ_cp uint64[nb+1,4], primary, sa_samples int64)
    without ever materializing the full suffix array. Peak memory is
    O(text + block) — ~27 bytes/char of BLOCK (not text), so a 6.2 G-char
    human doubled strand builds in <16 GB instead of the ~50 GB an int64
    SA-IS needs. Byte-identical artifacts to the SA-IS path
    (tests/test_bwt_merge.py)."""
    text = np.ascontiguousarray(text, dtype=np.uint8)
    n = len(text)
    if block_size is None:
        # 128M: the block working set (~23 B/char of BLOCK) stays ~2.9 GB,
        # which keeps the whole human-strand build inside a 32 GB budget
        block_size = int(os.environ.get("BISCUIT_TPU_BWT_BLOCK",
                                        str(128 * 1024 * 1024)))
    block_size = max(2, min(block_size, 1 << 29))
    words = np.empty((n + 15) // 16, dtype=np.uint32)
    nb = (n + 127) // 128
    occ_cp = np.empty((nb + 1) * 4, dtype=np.uint64)
    sa = np.empty((n + sa_intv) // sa_intv, dtype=np.int64)
    primary = lib().bwt_merge_build(text, n, block_size, words, occ_cp,
                                    sa_intv, sa)
    if primary < 0:
        raise RuntimeError(f"bwt_merge_build failed rc={primary}")
    return words, occ_cp.reshape(nb + 1, 4), int(primary), sa


def bwt_from_sa(text: np.ndarray, sa: np.ndarray):
    """Return (bwt_codes uint8[n], primary) in the reference bwt_t convention
    (the '$' row removed; primary = rank of the row starting at position 0)."""
    text = np.ascontiguousarray(text, dtype=np.uint8)
    bwt = np.empty(len(text), dtype=np.uint8)
    if sa.dtype == np.int32:
        sa = np.ascontiguousarray(sa, dtype=np.int32)
        primary = lib().bwt_from_sa_i32(text, sa, bwt, len(text))
    else:
        sa = np.ascontiguousarray(sa, dtype=np.int64)
        primary = lib().bwt_from_sa_i64(text, sa, bwt, len(text))
    if primary < 0:
        raise RuntimeError("bwt_from_sa: SA does not contain 0")
    return bwt, int(primary)
