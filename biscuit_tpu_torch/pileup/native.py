"""ctypes glue for the C++ pileup window engine (native/pileup_native.cpp).

Python pre-extracts per-read tag state (YD>ZS>XG chain, NM/AS, MC mate
length) and ships flat arrays; the C++ side does the per-base walks,
counting, genotyping and VCF text emission. Byte-identical to
engine._pileup_window_fast (tests/test_torch_pileup_native.py).

Copy of biscuit_tpu/pileup/native.py with only this docstring changed:
its imports are relative, and resolve to the port's own modules. It
uses no torch: the `native` pileup engine of the port.
tests/test_torch_engine.py holds the copy to its source.
"""
import ctypes as C
from typing import List

import numpy as np

from .. import native
from ..io.sambam import AlnRecord
from .common import NCONTXTS, RefCache, get_mate_length

INT32_MIN = -(1 << 31)


class ConfC(C.Structure):
    _fields_ = [("is_nome", C.c_int32),
                ("ambi_redist", C.c_int32), ("somatic", C.c_int32),
                ("error", C.c_double), ("mu", C.c_double),
                ("mu_somatic", C.c_double), ("contam", C.c_double),
                ("prior1", C.c_double), ("prior2", C.c_double),
                ("min_base_qual", C.c_int32), ("min_read_len", C.c_int32),
                ("min_dist_end_5p", C.c_int32), ("min_dist_end_3p", C.c_int32),
                ("min_mapq", C.c_int32), ("min_score", C.c_int32),
                ("max_nm", C.c_int32), ("max_retention", C.c_int32),
                ("filter_ppair", C.c_int32), ("filter_secondary", C.c_int32),
                ("filter_duplicate", C.c_int32), ("filter_qcfail", C.c_int32),
                ("filter_doublecnt", C.c_int32)]


class ReadC(C.Structure):
    _fields_ = [("pos", C.c_int64), ("mpos", C.c_int64),
                ("flag", C.c_int32), ("mapq", C.c_int32),
                ("l_qseq", C.c_int32), ("nm", C.c_int32), ("as_", C.c_int32),
                ("bs_known", C.c_int32), ("mate_len", C.c_int32),
                ("sid", C.c_int32),
                ("seq_off", C.c_int64), ("seq_len", C.c_int32),
                ("qual_off", C.c_int64), ("qual_len", C.c_int32),
                ("cig_off", C.c_int64), ("n_cigar", C.c_int32)]


def _confc(conf) -> ConfC:
    c = ConfC()
    c.is_nome = conf.comm.is_nome
    c.ambi_redist = conf.ambi_redist
    c.somatic = conf.somatic
    c.error, c.mu = conf.error, conf.mu
    c.mu_somatic, c.contam = conf.mu_somatic, conf.contam
    c.prior1, c.prior2 = conf.prior1, conf.prior2
    f = conf.filt
    c.min_base_qual = f.min_base_qual
    c.min_read_len = f.min_read_len
    c.min_dist_end_5p = f.min_dist_end_5p
    c.min_dist_end_3p = f.min_dist_end_3p
    c.min_mapq = f.min_mapq
    c.min_score = f.min_score
    c.max_nm = f.max_nm
    c.max_retention = f.max_retention
    c.filter_ppair = f.filter_ppair
    c.filter_secondary = f.filter_secondary
    c.filter_duplicate = f.filter_duplicate
    c.filter_qcfail = f.filter_qcfail
    c.filter_doublecnt = f.filter_doublecnt
    return c


def _bs_known(r: AlnRecord) -> int:
    """YD > ZS > XG tag chain (bisc_utils.c:208-238 with allow_u=0); -1 means
    the C++ side infers from C2T/G2A counts."""
    yd = r.get_tag("YD")
    if yd is not None:
        if yd == "f":
            return 0
        if yd == "r":
            return 1
    zs = r.get_tag("ZS")
    if zs is not None:
        if str(zs).startswith("+"):
            return 0
        if str(zs).startswith("-"):
            return 1
    xg = r.get_tag("XG")
    if xg is not None:
        if xg == "CT":
            return 0
        if xg == "GA":
            return 1
    return -1


class RawBamBase:
    """Common base for raw-BAM window sources (isinstance gate in
    engine.pileup_window and the epiread driver)."""


class RawBam(RawBamBase):
    """Decompressed BAM blob + C++-built record index: window queries become
    numpy masks over (tid, pos, rend) and the C++ engine parses records
    straight from the blob (no per-read Python objects)."""

    def __init__(self, path: str):
        from ..io import bgzf
        from ..io.sambam import _parse_bam_header

        L = native.lib()  # argtypes/restype centralized in native._declare
        self.data = bgzf.decompress(path)
        self.header, body_off = _parse_bam_header(self.data)
        n = L.bt_bam_scan(self.data, len(self.data), body_off,
                          None, None, None, None, C.c_int64(0))
        self.offs = np.zeros(max(n, 1), np.int64)
        self.tids = np.zeros(max(n, 1), np.int32)
        self.poss = np.zeros(max(n, 1), np.int64)
        self.rends = np.zeros(max(n, 1), np.int64)
        if n:
            got = L.bt_bam_scan(
                self.data, len(self.data), body_off,
                self.offs.ctypes.data_as(C.POINTER(C.c_int64)),
                self.tids.ctypes.data_as(C.POINTER(C.c_int32)),
                self.poss.ctypes.data_as(C.POINTER(C.c_int64)),
                self.rends.ctypes.data_as(C.POINTER(C.c_int64)),
                C.c_int64(n))
            assert got == n
        self.n = n

    def window_offsets(self, tid: int, beg: int, end: int) -> np.ndarray:
        """Record offsets overlapping the 1-based [beg, end) window, with the
        same bounds quirk as engine.pileup_window's fetch call."""
        fb = (beg - 1) if beg > 1 else 1
        fe = end
        span = np.maximum(self.rends - self.poss, 1)
        m = (self.tids == tid) & (self.poss < fe) & (self.poss + span > fb)
        return self.offs[m]


def raw_bam_open(path: str):
    """RawBamStream when a usable .bai sits next to the BAM (bounded
    memory), else whole-blob RawBam. A corrupt/unreadable .bai demotes to
    RawBam with a warning rather than failing the run."""
    import os
    import sys

    if os.path.exists(path + ".bai"):
        try:
            return RawBamStream(path)
        except Exception as e:
            print(f"[biscuit_tpu] warning: ignoring {path}.bai ({e}); "
                  "falling back to in-memory BAM", file=sys.stderr)
    return RawBam(path)


class RawBamStream(RawBamBase):
    """Bounded-memory variant of RawBam: requires a .bai; each window
    decompresses only the BGZF blocks its records live in (htslib-style),
    so memory is O(window) instead of O(file)."""

    def __init__(self, path: str):
        import struct

        from ..io.bai import BaiIndex
        from ..io.sambam import _parse_bam_header_streaming

        self.path = path
        self.bai = BaiIndex.read(path + ".bai")
        self.header = _parse_bam_header_streaming(path)
        self._struct = struct

    def window_blob(self, tid: int, beg: int, end: int):
        """(blob bytes starting at a record boundary, record offsets within
        it overlapping the 1-based [beg, end) window)."""
        from ..io import bgzf

        struct = self._struct
        fb = (beg - 1) if beg > 1 else 1
        voff = self.bai.min_offset(tid, fb, end)
        if voff is None:
            return b"", np.zeros(0, np.int64)
        chunks = []
        with open(self.path, "rb") as f:
            f.seek(voff >> 16)
            first = bgzf._read_block(f)
            if first is None:
                return b"", np.zeros(0, np.int64)
            buf = bytearray(first[voff & 0xFFFF:])
            scanned = 0  # bytes whose records we've peeked
            done = False
            while not done:
                # peek complete records for the stop condition
                while scanned + 4 <= len(buf):
                    (sz,) = struct.unpack_from("<i", buf, scanned)
                    if scanned + 4 + sz > len(buf):
                        break
                    rtid, rpos = struct.unpack_from("<ii", buf, scanned + 4)
                    scanned += 4 + sz
                    if rtid > tid or rtid < 0 or (rtid == tid and rpos >= end):
                        done = True
                        buf = buf[:scanned]
                        break
                if done:
                    break
                nxt = bgzf._read_block(f)
                if nxt is None:
                    break
                buf += nxt
        blob = bytes(buf)
        L = native.lib()
        n = L.bt_bam_scan(blob, len(blob), 0, None, None, None, None,
                          C.c_int64(0))
        if n == 0:
            return blob, np.zeros(0, np.int64)
        offs = np.zeros(n, np.int64)
        tids = np.zeros(n, np.int32)
        poss = np.zeros(n, np.int64)
        rends = np.zeros(n, np.int64)
        L.bt_bam_scan(blob, len(blob), 0,
                      offs.ctypes.data_as(C.POINTER(C.c_int64)),
                      tids.ctypes.data_as(C.POINTER(C.c_int32)),
                      poss.ctypes.data_as(C.POINTER(C.c_int64)),
                      rends.ctypes.data_as(C.POINTER(C.c_int64)),
                      C.c_int64(n))
        span = np.maximum(rends - poss, 1)
        m = (tids == tid) & (poss < end) & (poss + span > fb)
        return blob, np.ascontiguousarray(offs[m], np.int64)


def pileup_window_native_raw(rawbams, rs: RefCache, conf, tid: int, chrm: str,
                             beg: int, end: int, betasum_context,
                             cnt_context) -> str:
    """Raw-BAM window: C++ parses records from the shared blob."""
    L = native.lib()  # argtypes/restype centralized in native._declare

    rs.fetch(chrm, beg - 100 if beg > 100 else 1, end + 100)
    chrom = rs.arr
    n_bams = len(rawbams)
    blobs = []
    sel = []
    for rb in rawbams:
        if isinstance(rb, RawBamStream):
            blob, offs = rb.window_blob(tid, beg, end)
            blobs.append(blob)
            sel.append(offs)
        else:
            blobs.append(rb.data)
            sel.append(np.ascontiguousarray(
                rb.window_offsets(tid, beg, end), np.int64))
    blobs = [b if b else b"\0" for b in blobs]  # keep refs alive for the call
    datas = (C.c_void_p * n_bams)(
        *[C.cast(C.c_char_p(b), C.c_void_p) for b in blobs])
    data_lens = np.array(
        [len(b) if s_.size else 0 for b, s_ in zip(blobs, sel)], np.int64)
    offs_ptrs = (C.c_void_p * n_bams)(
        *[s.ctypes.data_as(C.c_void_p) for s in sel])
    n_recs = np.array([len(s) for s in sel], np.int64)

    bs = np.zeros(n_bams * NCONTXTS, np.float64)
    cc = np.zeros(n_bams * NCONTXTS, np.int64)
    out_buf = C.c_void_p()
    out_len = C.c_int64()
    rc_ = L.bt_pileup_window_raw(
        C.byref(_confc(conf)), chrm.encode(),
        chrom.ctypes.data_as(C.c_void_p), rs.seqlen,
        C.c_int64(beg), C.c_int64(end), n_bams,
        datas, data_lens.ctypes.data_as(C.c_void_p),
        offs_ptrs, n_recs.ctypes.data_as(C.c_void_p),
        C.byref(out_buf), C.byref(out_len),
        bs.ctypes.data_as(C.c_void_p), cc.ctypes.data_as(C.c_void_p))
    if rc_ != 0:
        raise RuntimeError(f"bt_pileup_window_raw rc={rc_}")
    try:
        text = C.string_at(out_buf, out_len.value).decode()
    finally:
        L.bt_buf_free(out_buf)
    for sid in range(n_bams):
        for k in range(NCONTXTS):
            betasum_context[sid][k] += bs[sid * NCONTXTS + k]
            cnt_context[sid][k] += int(cc[sid * NCONTXTS + k])
    return text


def pileup_window_native(bams, rs: RefCache, conf, tid: int, chrm: str,
                         beg: int, end: int, betasum_context,
                         cnt_context) -> str:
    """Drop-in for engine.pileup_window (non-verbose)."""
    L = native.lib()  # argtypes/restype centralized in native._declare

    rs.fetch(chrm, beg - 100 if beg > 100 else 1, end + 100)
    chrom = rs.arr  # uppercased uint8 array
    n_bams = len(bams)

    rows: List[ReadC] = []
    seq_parts: List[bytes] = []
    qual_parts: List[bytes] = []
    ops_parts: List[np.ndarray] = []
    lens_parts: List[np.ndarray] = []
    seq_off = qual_off = cig_off = 0
    for sid, bam in enumerate(bams):
        for b in bam.fetch(tid, (beg - 1) if beg > 1 else 1, end):
            rc = ReadC()
            rc.pos = b.pos
            rc.mpos = b.mpos
            rc.flag = b.flag
            rc.mapq = b.mapq
            rc.l_qseq = b.l_qseq
            nm = b.get_tag("NM")
            rc.nm = nm if nm is not None else INT32_MIN
            as_ = b.get_tag("AS")
            rc.as_ = as_ if as_ is not None else INT32_MIN
            rc.bs_known = _bs_known(b)
            mc = b.get_tag("MC")
            rc.mate_len = get_mate_length(mc) if mc is not None else b.rlen()
            rc.sid = sid
            sb = b.seq.encode()
            rc.seq_off = seq_off
            rc.seq_len = len(sb)
            seq_parts.append(sb)
            seq_off += len(sb)
            qb = b.qual.encode() if (b.qual and b.qual != "*") else b""
            rc.qual_off = qual_off
            rc.qual_len = len(qb)
            qual_parts.append(qb)
            qual_off += len(qb)
            ops = np.array([op for op, _l in b.cigar], np.uint8)
            lns = np.array([l for _op, l in b.cigar], np.int32)
            rc.cig_off = cig_off
            rc.n_cigar = len(ops)
            ops_parts.append(ops)
            lens_parts.append(lns)
            cig_off += len(ops)
            rows.append(rc)

    n = len(rows)
    arr = (ReadC * n)(*rows) if n else (ReadC * 1)()
    seq_blob = C.create_string_buffer(b"".join(seq_parts), max(seq_off, 1))
    qual_blob = C.create_string_buffer(b"".join(qual_parts), max(qual_off, 1))
    cig_ops = np.concatenate(ops_parts) if ops_parts else np.zeros(1, np.uint8)
    cig_lens = np.concatenate(lens_parts) if lens_parts else np.zeros(1, np.int32)
    cig_ops = np.ascontiguousarray(cig_ops, np.uint8)
    cig_lens = np.ascontiguousarray(cig_lens, np.int32)

    bs = np.zeros(n_bams * NCONTXTS, np.float64)
    cc = np.zeros(n_bams * NCONTXTS, np.int64)
    out_buf = C.c_void_p()
    out_len = C.c_int64()
    rc_ = L.bt_pileup_window(
        C.byref(_confc(conf)), chrm.encode(),
        chrom.ctypes.data_as(C.c_void_p), rs.seqlen,
        C.c_int64(beg), C.c_int64(end), n_bams, arr, n,
        seq_blob, qual_blob,
        cig_ops.ctypes.data_as(C.c_void_p),
        cig_lens.ctypes.data_as(C.c_void_p),
        C.byref(out_buf), C.byref(out_len),
        bs.ctypes.data_as(C.c_void_p), cc.ctypes.data_as(C.c_void_p))
    if rc_ != 0:
        raise RuntimeError(f"bt_pileup_window rc={rc_}")
    try:
        text = C.string_at(out_buf, out_len.value).decode()
    finally:
        L.bt_buf_free(out_buf)
    for sid in range(n_bams):
        for k in range(NCONTXTS):
            betasum_context[sid][k] += bs[sid * NCONTXTS + k]
            cnt_context[sid][k] += int(cc[sid * NCONTXTS + k])
    return text
