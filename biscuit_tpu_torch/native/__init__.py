"""ctypes loader for the port's native (C++) components.

Compiles lazily with g++ on first use; the shared object is cached in
`_build/` next to the sources and rebuilt when a source is newer. This is
host C++, not a device kernel: the suffix array and BWT of index
construction (sais.cpp, bwt_merge.cpp), the native align engine
(align_host.cpp: seeding, chaining, extension and SAM for a batch of
reads on C++ threads, with the seed injection of the hybrid engine), the
pileup and epiread window engines over raw BAM records (pileup_native.cpp,
whose text buffers bt_buf_free of align_host.cpp frees: one library) and
the line filters of vcf2bed and mergecg (streams_native.cpp).

Copy of biscuit_tpu/native/__init__.py for those five sources: `_declare`
is the source's whole table, and the PGO and sanitizer builds of the
source are left out. No source includes zlib, so the source's -lz is not
needed. The rest is the source's code; tests/test_torch_engine.py holds
the copy to it.
"""
import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "_build", "libbiscuit_native.so")
_SOURCES = [os.path.join(_DIR, f) for f in sorted(os.listdir(_DIR)) if f.endswith(".cpp")]

_lib = None


def _stale() -> bool:
    return not os.path.exists(_SO) or any(
        os.path.getmtime(src) > os.path.getmtime(_SO)
        for src in _SOURCES + [os.path.join(_DIR, "__init__.py")])


def _build() -> None:
    import fcntl
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    # one build at a time: processes that start together (test workers)
    # wait for the first one's library instead of compiling it again
    with open(_SO + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale():
            return
        # built under a process-private name and renamed: a concurrent
        # process never loads a torn file
        tmp = f"{_SO}.{os.getpid()}.tmp"
        # c++20: the interleaved SMEM seeder (align_host.cpp) uses coroutines
        base = ["g++", "-O3", "-funroll-loops", "-std=c++20", "-shared",
                "-fPIC", "-o", tmp]
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
        if _stale():
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

    # Pointer params are declared c_void_p: it accepts every call-site form
    # in use (bytes, None, byref(Structure), ctypes arrays, string buffers,
    # numpy .ctypes.data_as(...)) while rejecting raw ndarrays (callers use
    # explicit data pointers). Scalars carry their exact C width so bare
    # Python ints can never truncate again.
    P, i32, i64, f64 = (ctypes.c_void_p, ctypes.c_int32,
                        ctypes.c_int64, ctypes.c_double)

    # --- align_host.cpp ---
    L.bt_buf_free.argtypes = [P]
    L.bt_buf_free.restype = None
    L.bt_hugify.argtypes = [P, i64]
    L.bt_hugify.restype = P
    L.bt_build_ilv.argtypes = [P]
    L.bt_build_ilv.restype = P
    L.bt_build_ilv2.argtypes = [P]
    L.bt_build_ilv2.restype = P
    L.bt_sw_extend.argtypes = [P, i32, P, i32, P, i32, i32, i32, i32,
                               i32, i32, i32, i32, i32, P]
    L.bt_sw_extend.restype = i32
    L.bt_occ_cg_x8.argtypes = [P, P, i32, P, P]
    L.bt_occ_cg_x8.restype = i32
    L.bt_occ_cg_x8v.argtypes = [P, P, P, P, P]
    L.bt_occ_cg_x8v.restype = i32
    L.bt_occ_cg_scalar.argtypes = [P, i64, i32, P, P]
    L.bt_occ_cg_scalar.restype = i32
    L.bt_occ_bench.argtypes = [P, i64, i32, i32]
    L.bt_occ_bench.restype = i64
    L.bt_worker1_batch.argtypes = [P, P, P, P, P, P, P, i32, P, i32, P, i32]
    L.bt_worker1_batch.restype = i32
    L.bt_align_se_batch.argtypes = (
        [P] * 5 +                      # dau, par, bns, optc, o2c
        [P] * 3 + [P] * 3 + [P] * 3 +  # reads/offs/lens ×{clipped,full,qual}
        [P] * 3 + [P, P, P] +          # names triple, clip5, clip3, py_only
        [P, P] +                       # ann_names_cat, ann_name_offs
        [P, i32, i64, i32, i32] +      # rg, rg_len, n_processed, n, threads
        [P] +                          # inj
        [P, P, P])                     # out_buf, out_lens, status
    L.bt_align_se_batch.restype = i32
    L.bt_align_pe_batch.argtypes = (
        [P] * 6 +                      # dau, par, bns, optc, o2c, o3c
        [P] * 3 + [P] * 3 + [P] * 3 +
        [P] * 3 + [P, P, P] +
        [P, P] +
        [P, i32, i64, i32, i32] +
        [P, i32] +                     # pes_io, pes_given
        [P] +                          # inj
        [P, P, P])
    L.bt_align_pe_batch.restype = i32

    # --- pileup_native.cpp ---
    L.bt_bam_scan.argtypes = [P, i64, i64, P, P, P, P, i64]
    L.bt_bam_scan.restype = i64
    L.bt_pileup_window.argtypes = [P, P, P, i64, i64, i64, i32, P, i32,
                                   P, P, P, P, P, P, P, P]
    L.bt_pileup_window.restype = i32
    L.bt_pileup_window_raw.argtypes = [P, P, P, i64, i64, i64, i32,
                                       P, P, P, P, P, P, P, P]
    L.bt_pileup_window_raw.restype = i32
    L.bt_epiread_window_raw.argtypes = [
        P, i32, i32, i32, i32, i32, i32,   # cf, nome, filt, maxlen, mode,
                                           # print_all, have_snps
        i32, f64,                          # use_modbam, modbam_prob
        P, P, i64, i64, i64,               # chrom_name, chrom, seqlen,
                                           # rs_beg, rs_end
        i64, i64, i64, i64,                # beg, end, print_w_beg/end
        P, i64, P, i64,                    # data, data_len, rec_offs, n_recs
        P, P, i64,                         # snp_locs, snp_meth, n_snps
        P, P]                              # out_buf, out_len
    L.bt_epiread_window_raw.restype = i32

    # --- streams_native.cpp ---
    L.bt_stream_free.argtypes = [P]
    L.bt_stream_free.restype = None
    L.bt_vcf2bed_ctxt.argtypes = [ctypes.c_char_p, i64, i32, i32, i32,
                                  ctypes.c_char_p, i32p, i32,
                                  ctypes.POINTER(ctypes.c_int64)]
    L.bt_vcf2bed_ctxt.restype = P
    L.bt_mergecg_new.argtypes = [i32, i32, i32]
    L.bt_mergecg_new.restype = P
    L.bt_mergecg_set_ref.argtypes = [P, ctypes.c_char_p, ctypes.c_char_p, i64]
    L.bt_mergecg_set_ref.restype = None
    L.bt_mergecg_feed.argtypes = [P, ctypes.c_char_p, i64]
    L.bt_mergecg_feed.restype = i64
    L.bt_mergecg_need_chrom.argtypes = [P]
    L.bt_mergecg_need_chrom.restype = ctypes.c_char_p
    L.bt_mergecg_error.argtypes = [P]
    L.bt_mergecg_error.restype = i32
    L.bt_mergecg_errmsg.argtypes = [P]
    L.bt_mergecg_errmsg.restype = ctypes.c_char_p
    L.bt_mergecg_take_output.argtypes = [P, ctypes.POINTER(ctypes.c_int64)]
    L.bt_mergecg_take_output.restype = P
    L.bt_mergecg_finish.argtypes = [P]
    L.bt_mergecg_finish.restype = None
    L.bt_mergecg_free.argtypes = [P]
    L.bt_mergecg_free.restype = None


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
