"""Native (C++) worker1 engine: per-read seeding/chaining/extension runs in
biscuit_tpu_torch/native/align_host.cpp with std::thread parallelism; Python
keeps merge_regions, pairing and SAM emission. Output is identical to the
Python host engine (tests/test_torch_native.py).

Copy of biscuit_tpu/align/native_engine.py with only this docstring
changed: its imports are relative, and resolve to the port's own modules.
tests/test_torch_engine.py holds the copy to its source.
"""
import ctypes as C
import os
from typing import List, Optional

import numpy as np

from ..config import MemOpt, MEM_F_PE, MEM_F_NO_RESCUE, MEM_F_REF_HDR
from ..index.fmindex import BisIndex
from .. import native
from .io_helpers import read_clipping
from .pair import PeStat, pestat
from .pipeline import AlignerState, align1_core, worker2_pe, worker2_se
from .region import AlnReg, AlnRegs, merge_regions


class StrandFMC(C.Structure):
    _fields_ = [("words", C.c_void_p), ("occ", C.c_void_p), ("L2", C.c_void_p),
                ("sa", C.c_void_p), ("primary", C.c_int64),
                ("seq_len", C.c_int64), ("n_words", C.c_int64),
                ("ilv", C.c_void_p), ("sa_wide", C.c_int32),
                ("sa_shift", C.c_int32), ("ilv2", C.c_void_p)]


class BnsC(C.Structure):
    _fields_ = [("ann_off", C.c_void_p), ("ann_len", C.c_void_p),
                ("ann_alt", C.c_void_p), ("n_seqs", C.c_int32),
                ("pac", C.c_void_p), ("l_pac", C.c_int64)]


class OptC(C.Structure):
    _fields_ = [("a", C.c_int32), ("b", C.c_int32), ("o_del", C.c_int32),
                ("e_del", C.c_int32), ("o_ins", C.c_int32), ("e_ins", C.c_int32),
                ("pen_clip5", C.c_int32), ("pen_clip3", C.c_int32),
                ("w", C.c_int32), ("zdrop", C.c_int32),
                ("max_mem_intv", C.c_int64),
                ("min_seed_len", C.c_int32), ("split_width", C.c_int32),
                ("max_occ", C.c_int64), ("max_chain_gap", C.c_int32),
                ("split_factor", C.c_double), ("mask_level", C.c_double),
                ("drop_ratio", C.c_double), ("min_chain_weight", C.c_int32),
                ("max_chain_extend", C.c_int64), ("flag", C.c_int32),
                ("parent_policy", C.c_int32), ("bsstrand", C.c_int32),
                ("is_pe", C.c_int32),
                ("gamat", C.c_int8 * 25), ("ctmat", C.c_int8 * 25)]


class RegionC(C.Structure):
    _fields_ = [("rb", C.c_int64), ("re", C.c_int64), ("qb", C.c_int32),
                ("qe", C.c_int32), ("rid", C.c_int32), ("score", C.c_int32),
                ("truesc", C.c_int32), ("w", C.c_int32), ("seedcov", C.c_int32),
                ("seedlen0", C.c_int32), ("frac_rep", C.c_float),
                ("bss", C.c_uint8), ("parent", C.c_uint8),
                ("pad0", C.c_uint8), ("pad1", C.c_uint8)]


class Opt2C(C.Structure):
    _fields_ = [("T", C.c_int32),
                ("XA_drop_ratio", C.c_double), ("mask_level_redun", C.c_double),
                ("mapQ_coef_len", C.c_double), ("mapQ_coef_fac", C.c_double),
                ("max_XA_hits", C.c_int32), ("max_XA_hits_alt", C.c_int32),
                ("pen_unpaired", C.c_int32), ("pad", C.c_int32)]


class Opt3C(C.Structure):
    _fields_ = [("max_ins", C.c_int64), ("max_matesw", C.c_int32),
                ("verbose", C.c_int32)]


class PeStatC(C.Structure):
    _fields_ = [("low", C.c_int64), ("high", C.c_int64),
                ("set_", C.c_int32), ("failed", C.c_int32),
                ("avg", C.c_double), ("std_", C.c_double)]


class SeedInjC(C.Structure):
    """Device-computed seed injection (align_host.cpp SeedInj): per-lane
    collect_intv rows + prefetched SA positions. Built by
    device_engine.DeviceSeeder; lanes without `has` self-seed in C++."""
    _fields_ = [("has", C.c_void_p), ("lane_off", C.c_void_p),
                ("rows_se", C.c_void_p), ("rows_xs", C.c_void_p),
                ("sa_off", C.c_void_p), ("sa_pos", C.c_void_p)]


REG_CAP = 96


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(C.c_void_p)


def _pack_strs(items: List[bytes]):
    """Concatenate byte strings; return (buffer, offsets[n], lens[n])."""
    n = len(items)
    offs = np.zeros(n, np.int64)
    lens = np.zeros(n, np.int32)
    total = 0
    for i, b in enumerate(items):
        offs[i] = total
        lens[i] = len(b)
        total += len(b)
    buf = C.create_string_buffer(b"".join(items), max(total, 1))
    return buf, offs, lens


class NativeAligner:
    def __init__(self, st: AlignerState):
        self.st = st
        idx = st.idx
        self.lib = native.lib()  # argtypes centralized in native._declare
        # keep buffers alive
        self._bufs = []
        self._ilv_ptrs = []

        def hugify(arr):
            """THP-backed copy of a hot random-access array (>= 64 MB by
            default; BISCUIT_TPU_HUGEPAGES=0 disables): at DRAM scale 4 KB
            TLB misses ~double the rank-walk latency (docs/SCALING.md).
            Returns a raw pointer (freed in __del__) or None to keep the
            original buffer."""
            mode = os.environ.get("BISCUIT_TPU_HUGEPAGES", "")
            if mode == "0" or (mode == "" and arr.nbytes < (64 << 20)):
                return None
            p = self.lib.bt_hugify(arr.ctypes.data, arr.nbytes)
            if p:
                self._ilv_ptrs.append(p)
            return p

        def strand(s, tag):
            import os

            occ = np.ascontiguousarray(s.occ_cp.astype(np.int64))
            words = np.ascontiguousarray(s.words)
            L2 = np.ascontiguousarray(s.L2.astype(np.int64))
            # wide (>=2^31) strands carry int64 SA samples with a literal -1
            # '$' sentinel; narrow ones the uint32 wrap layout
            sa_wide = 1 if s.sa_samples.dtype.itemsize == 8 else 0
            sa = np.ascontiguousarray(
                s.sa_samples.astype(np.int64 if sa_wide else np.uint32))
            self._bufs += [occ, words, L2, sa]
            sa_shift = int(getattr(s, "sa_intv", 32)).bit_length() - 1
            fm = StrandFMC(_ptr(words), _ptr(occ), _ptr(L2), _ptr(sa),
                           s.primary, s.seq_len, len(words), None, sa_wide,
                           sa_shift, None)
            sa_hp = hugify(sa)  # SA walks are uniformly random reads
            if sa_hp:
                fm.sa = sa_hp
            # dense 64-base interleaved blocks (narrow strands); with an
            # mmap-layout index the blocks persist in the .btidx dir so
            # later processes map them instead of rebuilding
            mmap_dir = getattr(idx, "mmap_dir", None)
            nb2 = (s.seq_len + 63) >> 6
            cache = (os.path.join(mmap_dir, f"{tag}_ilv2.npy")
                     if mmap_dir else None)
            if cache and os.path.exists(cache):
                # staleness guard: the blocks derive from {tag}_words.npy, so
                # a cache older than its source (e.g. left behind by a tool
                # that rewrote the arrays without save_mmap's cleanup) must
                # not be trusted on byte-length alone
                src = os.path.join(mmap_dir, f"{tag}_words.npy")
                fresh = (not os.path.exists(src) or
                         os.path.getmtime(cache) >= os.path.getmtime(src))
                arr = np.load(cache, mmap_mode="r") if fresh else None
                if arr is not None and arr.nbytes == nb2 * 32:
                    hp = hugify(arr)
                    if hp:
                        fm.ilv2 = hp
                    else:
                        self._bufs.append(arr)
                        fm.ilv2 = arr.ctypes.data  # read-only pages
                    return fm
            ilv2 = self.lib.bt_build_ilv2(C.byref(fm))
            if ilv2:
                self._ilv_ptrs.append(ilv2)
                fm.ilv2 = ilv2
                if cache:
                    try:
                        a = np.frombuffer(
                            C.string_at(ilv2, nb2 * 32), np.uint8)
                        # ends in .npy so np.save won't append a suffix
                        tmp = f"{cache}.{os.getpid()}.tmp.npy"
                        np.save(tmp, a)
                        os.replace(tmp, cache)
                    except OSError:
                        pass  # read-only dir: just keep the in-memory blocks
            else:
                ilv = self.lib.bt_build_ilv(C.byref(fm))
                if ilv:
                    self._ilv_ptrs.append(ilv)
                    fm.ilv = ilv
            return fm

        self.dau = strand(idx.dau, "dau")
        self.par = strand(idx.par, "par")
        ann_off = np.ascontiguousarray(
            np.array([a.offset for a in idx.anns], np.int64))
        # int64: a single contig may exceed 2^31 chars (the reference's
        # bntann1_t caps contig length at int32; we don't)
        ann_len = np.ascontiguousarray(
            np.array([a.length for a in idx.anns], np.int64))
        ann_alt = np.ascontiguousarray(
            np.array([getattr(a, "is_alt", 0) for a in idx.anns], np.uint8))
        pac = np.ascontiguousarray(idx.pac)
        self._bufs += [ann_off, ann_len, ann_alt, pac]
        self.bns = BnsC(_ptr(ann_off), _ptr(ann_len), _ptr(ann_alt),
                        len(idx.anns), _ptr(pac), idx.l_pac)

    def __del__(self):
        try:
            for p in getattr(self, "_ilv_ptrs", []):
                self.lib.bt_buf_free(p)
        except Exception:
            pass

    def _optc(self, opt: MemOpt) -> OptC:
        o = OptC()
        o.a, o.b = opt.a, opt.b
        o.o_del, o.e_del = opt.o_del, opt.e_del
        o.o_ins, o.e_ins = opt.o_ins, opt.e_ins
        o.pen_clip5, o.pen_clip3 = opt.pen_clip5, opt.pen_clip3
        o.w, o.zdrop = opt.w, opt.zdrop
        o.max_mem_intv = opt.max_mem_intv
        o.min_seed_len = opt.min_seed_len
        o.split_width = opt.split_width
        o.max_occ = opt.max_occ
        o.max_chain_gap = opt.max_chain_gap
        o.split_factor = opt.split_factor
        o.mask_level = opt.mask_level
        o.drop_ratio = opt.drop_ratio
        o.min_chain_weight = opt.min_chain_weight
        o.max_chain_extend = opt.max_chain_extend
        o.flag = opt.flag
        o.parent_policy = opt.parent
        o.bsstrand = opt.bsstrand
        o.is_pe = 1 if (opt.flag & MEM_F_PE) else 0
        o.gamat = (C.c_int8 * 25)(*[int(v) for v in opt.gamat.reshape(-1)])
        o.ctmat = (C.c_int8 * 25)(*[int(v) for v in opt.ctmat.reshape(-1)])
        return o

    def _opt2c(self, opt: MemOpt) -> Opt2C:
        o = Opt2C()
        o.T = opt.T
        o.XA_drop_ratio = opt.XA_drop_ratio
        o.mask_level_redun = opt.mask_level_redun
        o.mapQ_coef_len = opt.mapQ_coef_len
        o.mapQ_coef_fac = opt.mapQ_coef_fac
        o.max_XA_hits = opt.max_XA_hits
        o.max_XA_hits_alt = opt.max_XA_hits_alt
        o.pen_unpaired = opt.pen_unpaired
        return o

    def _marshal_reads(self, seqs):
        """Pack per-read arrays for the fused C++ batch calls. Returns a dict
        whose values must stay alive for the duration of the call."""
        n = len(seqs)
        lens = np.fromiter((s.l_seq for s in seqs), np.int32, n)
        offs = np.zeros(n, np.int64)
        np.cumsum(lens[:-1], dtype=np.int64, out=offs[1:])
        reads = (np.concatenate([s.seq for s in seqs])
                 if n else np.zeros(1, np.uint8))
        if all(s.seq0 is s.seq for s in seqs):
            # unclipped batch: full view == clipped view, share the buffer
            reads0, offs0, lens0 = reads, offs, lens.copy()
        else:
            lens0 = np.fromiter((s.l_seq0 for s in seqs), np.int32, n)
            offs0 = np.zeros(n, np.int64)
            np.cumsum(lens0[:-1], dtype=np.int64, out=offs0[1:])
            reads0 = (np.concatenate([s.seq0 for s in seqs])
                      if n else np.zeros(1, np.uint8))
        quals, qoffs, qlens = _pack_strs(
            [(s.qual.encode() if s.qual is not None else b"") for s in seqs])
        names, noffs, nlens = _pack_strs(
            [(s.name if not s.comment else f"{s.name}_{s.comment}").encode()
             for s in seqs])
        clip5 = np.array([s.clip5 for s in seqs], np.int32)
        clip3 = np.array([s.clip3 for s in seqs], np.int32)
        py_only = np.array(
            [1 if (s.barcode or s.umi) else 0 for s in seqs], np.uint8)
        ann_nm = [a.name.encode() for a in self.st.idx.anns]
        ann_cat = b"".join(ann_nm)
        ann_offs = np.zeros(len(ann_nm) + 1, np.int64)
        for i, b in enumerate(ann_nm):
            ann_offs[i + 1] = ann_offs[i] + len(b)
        ann_buf = C.create_string_buffer(ann_cat, max(len(ann_cat), 1))
        return dict(reads=reads, offs=offs, lens=lens, reads0=reads0,
                    offs0=offs0, lens0=lens0, quals=quals, qoffs=qoffs,
                    qlens=qlens, names=names, noffs=noffs, nlens=nlens,
                    clip5=clip5, clip3=clip3, py_only=py_only,
                    ann_buf=ann_buf, ann_offs=ann_offs)

    def _collect_sams(self, out_buf, out_lens, status, n) -> List[Optional[str]]:
        try:
            total = int(out_lens.sum())
            blob = C.string_at(out_buf, total) if total else b""
        finally:
            self.lib.bt_buf_free(out_buf)
        sams: List[Optional[str]] = [None] * n
        off = 0
        for i in range(n):
            ln = int(out_lens[i])
            if status[i] == 0:
                sams[i] = blob[off:off + ln].decode()
            off += ln
        return sams

    def align_se_batch(self, opt: MemOpt, seqs, n_processed: int,
                       rg_id: str, n_threads: int,
                       inj=None) -> List[Optional[str]]:
        """Fused C++ worker1+worker2 for SE reads (bt_align_se_batch).
        Returns per-read SAM text, or None for reads needing the Python
        fallback. Reads must already be clipped (read_clipping). `inj` is an
        optional (SeedInjC, keepalive) pair from DeviceSeeder."""
        n = len(seqs)
        L = self.lib
        m = self._marshal_reads(seqs)
        rgb = rg_id.encode()
        out_buf = C.c_void_p()
        out_lens = np.zeros(n, np.int64)
        status = np.zeros(n, np.int32)
        rc = L.bt_align_se_batch(
            C.byref(self.dau), C.byref(self.par), C.byref(self.bns),
            C.byref(self._optc(opt)), C.byref(self._opt2c(opt)),
            _ptr(m["reads"]), _ptr(m["offs"]), _ptr(m["lens"]),
            _ptr(m["reads0"]), _ptr(m["offs0"]), _ptr(m["lens0"]),
            m["quals"], _ptr(m["qoffs"]), _ptr(m["qlens"]),
            m["names"], _ptr(m["noffs"]), _ptr(m["nlens"]),
            _ptr(m["clip5"]), _ptr(m["clip3"]), _ptr(m["py_only"]),
            m["ann_buf"], _ptr(m["ann_offs"]),
            rgb, len(rgb), C.c_int64(n_processed), n, n_threads,
            C.byref(inj[0]) if inj is not None else None,
            C.byref(out_buf), _ptr(out_lens), _ptr(status))
        if rc != 0:
            raise RuntimeError(f"bt_align_se_batch rc={rc}")
        return self._collect_sams(out_buf, out_lens, status, n)

    def align_pe_batch(self, opt: MemOpt, seqs, n_processed: int,
                       rg_id: str, n_threads: int, pes0=None, inj=None):
        """Fused C++ PE batch (bt_align_pe_batch). Returns (sams, pes):
        per-read SAM text (None = Python fallback for that pair; all-None =
        rerun the whole batch in Python) and the PeStat used."""
        n = len(seqs)
        L = self.lib
        m = self._marshal_reads(seqs)
        rgb = rg_id.encode()
        o3 = Opt3C()
        o3.max_ins = opt.max_ins
        o3.max_matesw = opt.max_matesw
        o3.verbose = 1
        pc = PeStatC()
        if pes0 is not None:
            pc.low, pc.high = pes0.low, pes0.high
            pc.set_, pc.failed = pes0.set, pes0.failed
            pc.avg, pc.std_ = pes0.avg, pes0.std
        out_buf = C.c_void_p()
        out_lens = np.zeros(n, np.int64)
        status = np.zeros(n, np.int32)
        rc = L.bt_align_pe_batch(
            C.byref(self.dau), C.byref(self.par), C.byref(self.bns),
            C.byref(self._optc(opt)), C.byref(self._opt2c(opt)), C.byref(o3),
            _ptr(m["reads"]), _ptr(m["offs"]), _ptr(m["lens"]),
            _ptr(m["reads0"]), _ptr(m["offs0"]), _ptr(m["lens0"]),
            m["quals"], _ptr(m["qoffs"]), _ptr(m["qlens"]),
            m["names"], _ptr(m["noffs"]), _ptr(m["nlens"]),
            _ptr(m["clip5"]), _ptr(m["clip3"]), _ptr(m["py_only"]),
            m["ann_buf"], _ptr(m["ann_offs"]),
            rgb, len(rgb), C.c_int64(n_processed), n, n_threads,
            C.byref(pc), 1 if pes0 is not None else 0,
            C.byref(inj[0]) if inj is not None else None,
            C.byref(out_buf), _ptr(out_lens), _ptr(status))
        if rc != 0:
            raise RuntimeError(f"bt_align_pe_batch rc={rc}")
        pes = PeStat(low=int(pc.low), high=int(pc.high), set=int(pc.set_),
                     failed=int(pc.failed), avg=float(pc.avg),
                     std=float(pc.std_)) if pes0 is None else pes0
        return self._collect_sams(out_buf, out_lens, status, n), pes

    def worker1_batch(self, opt: MemOpt, seqs, n_threads: int) -> List[AlnRegs]:
        n = len(seqs)
        offs = np.zeros(n, np.int64)
        lens = np.zeros(n, np.int32)
        total = 0
        for i, s in enumerate(seqs):
            offs[i] = total
            lens[i] = s.l_seq
            total += s.l_seq
        reads = np.zeros(total, np.uint8)
        for i, s in enumerate(seqs):
            reads[offs[i]:offs[i] + s.l_seq] = s.seq
        out = np.zeros(n * REG_CAP, dtype=np.dtype([
            ("rb", np.int64), ("re", np.int64), ("qb", np.int32),
            ("qe", np.int32), ("rid", np.int32), ("score", np.int32),
            ("truesc", np.int32), ("w", np.int32), ("seedcov", np.int32),
            ("seedlen0", np.int32), ("frac_rep", np.float32),
            ("bss", np.uint8), ("parent", np.uint8),
            ("pad0", np.uint8), ("pad1", np.uint8)]))
        out_n = np.zeros(n, np.int32)
        rc = self.lib.bt_worker1_batch(
            C.byref(self.dau), C.byref(self.par), C.byref(self.bns),
            C.byref(self._optc(opt)), _ptr(reads), _ptr(offs), _ptr(lens),
            n, _ptr(out), REG_CAP, _ptr(out_n), n_threads)
        if rc != 0:
            raise RuntimeError(f"bt_worker1_batch rc={rc}")
        return out, out_n

    def build_regs(self, opt: MemOpt, seqs, out, out_n, i0: int,
                   merge: bool = True) -> List[AlnRegs]:
        """Unpack RegionC rows (or rerun fallback reads in Python) and
        optionally merge. i0 = global index of seqs[0] (PE policy parity)."""
        all_regs: List[AlnRegs] = []
        pe = bool(opt.flag & MEM_F_PE)
        for j, s in enumerate(seqs):
            i = i0 + j
            regs = AlnRegs()
            if out_n[j] < 0:
                # fallback: rerun this read's strand passes in Python
                if not pe:
                    if not (opt.parent & 1) or (opt.parent >> 1):
                        align1_core(opt, self.st, s, regs, 0)
                    if not (opt.parent & 1) or not (opt.parent >> 1):
                        align1_core(opt, self.st, s, regs, 1)
                else:
                    first = 1 if i % 2 == 0 else 0
                    align1_core(opt, self.st, s, regs, first)
                    if not opt.parent:
                        align1_core(opt, self.st, s, regs, 1 - first)
            else:
                rows = out[j * REG_CAP:j * REG_CAP + out_n[j]]
                for r in rows:
                    reg = AlnReg()
                    reg.rb = int(r["rb"])
                    reg.re = int(r["re"])
                    reg.qb = int(r["qb"])
                    reg.qe = int(r["qe"])
                    reg.rid = int(r["rid"])
                    reg.score = int(r["score"])
                    reg.truesc = int(r["truesc"])
                    reg.w = int(r["w"])
                    reg.seedcov = int(r["seedcov"])
                    reg.seedlen0 = int(r["seedlen0"])
                    reg.frac_rep = float(r["frac_rep"])
                    reg.bss = int(r["bss"])
                    reg.parent = int(r["parent"])
                    regs.append(reg)
            if merge:
                merge_regions(opt, self.st.idx, s.seq, s.l_seq, regs)
            all_regs.append(regs)
        return all_regs


_W2_STATE = {}


def _w2_init(opt, st, rg_id):
    _W2_STATE.update(opt=opt, st=st, rg_id=rg_id)
    _W2_STATE["nat"] = None


def _w2_nat():
    if _W2_STATE["nat"] is None:
        _W2_STATE["nat"] = NativeAligner(_W2_STATE["st"])
    return _W2_STATE["nat"]


def _w2_se_chunk(args):
    lo, seqs, out_rows, out_n, n_processed = args
    opt, st, rg_id = _W2_STATE["opt"], _W2_STATE["st"], _W2_STATE["rg_id"]
    regs_list = _w2_nat().build_regs(opt, seqs, out_rows, out_n, lo)
    sams = []
    for j, (s, regs) in enumerate(zip(seqs, regs_list)):
        worker2_se(opt, st, s, regs, n_processed, lo + j, rg_id)
        sams.append(s.sam)
    return lo, sams


def _pe_build_chunk(args):
    lo, seqs, out_rows, out_n = args
    opt = _W2_STATE["opt"]
    return lo, _w2_nat().build_regs(opt, seqs, out_rows, out_n, lo)


def _w2_pe_chunk(args):
    lo, seqs, regs_list, pes, n_processed = args
    opt, st, rg_id = _W2_STATE["opt"], _W2_STATE["st"], _W2_STATE["rg_id"]
    out = []
    for j in range(0, len(seqs), 2):
        pair = (seqs[j], seqs[j + 1])
        rp = (regs_list[j], regs_list[j + 1])
        worker2_pe(opt, st, pair, rp, pes, n_processed, lo + (j >> 1), rg_id)
        out.append((pair[0].sam, pair[1].sam))
    return lo, out


def process_seqs_native(opt: MemOpt, st: AlignerState, seqs, n_processed: int,
                        pes0=None, rg_id: str = "",
                        engine: Optional[NativeAligner] = None,
                        seeder=None, inj_pre=None,
                        pre_clipped: bool = False) -> None:
    """mem_process_seqs with the native worker1 (C++ threads) and worker2
    fanned out over a fork pool (exact: PE insert-size stats still span the
    whole chunk, as in the reference). `seeder` is an optional
    device_engine.DeviceSeeder: seeds + SA prefetches then come from the TPU
    (seed injection), C++ keeps the branchy chain/extend/SAM stages.
    `inj_pre`/`pre_clipped`: the hybrid pipeline (process_seqs_hybrid)
    builds the next sub-batch's injection on device WHILE C++ aligns the
    current one; it clips and injects up front and passes the result in."""
    nat = engine or NativeAligner(st)
    pe = bool(opt.flag & MEM_F_PE)
    if pe:
        for i in range(0, len(seqs), 2):
            s1, s2 = seqs[i], seqs[i + 1]
            if s1.name != s2.name and not (
                    s1.name[:-1] == s2.name[:-1] and s1.name[-1] == "1"
                    and s2.name[-1] == "2"):
                raise RuntimeError(
                    f'paired reads have different names: "{s1.name}", "{s2.name}"')
    if not pre_clipped:
        for s in seqs:
            read_clipping(s, opt.adaptor1 if (not pe or s.id % 2 == 0)
                          else opt.adaptor2, opt)
    inj = inj_pre if inj_pre is not None else (
        seeder.build_injection(opt, seqs, pe) if seeder is not None else None)

    n_workers = max(1, opt.n_threads)
    from . import pair as pairmod
    if pe and not (opt.flag & MEM_F_REF_HDR) and pairmod.ISIZE_EXCHANGE is None:
        # the fused C++ path computes pes internally from its own chunk; a
        # multi-host isize exchange needs the Python pestat below
        sams, pes = nat.align_pe_batch(opt, seqs, n_processed, rg_id,
                                       n_workers, pes0, inj=inj)
        if any(s is not None for s in sams):
            for pi in range(len(seqs) >> 1):
                i0 = pi << 1
                if sams[i0] is not None:
                    seqs[i0].sam = sams[i0]
                    seqs[i0 + 1].sam = sams[i0 + 1]
                    continue
                # per-pair Python fallback, reusing the batch pes
                rp = []
                for i in (i0, i0 + 1):
                    s = seqs[i]
                    regs = AlnRegs()
                    first = 1 if i % 2 == 0 else 0
                    align1_core(opt, st, s, regs, first)
                    if not opt.parent:
                        align1_core(opt, st, s, regs, 1 - first)
                    merge_regions(opt, st.idx, s.seq, s.l_seq, regs)
                    rp.append(regs)
                worker2_pe(opt, st, (seqs[i0], seqs[i0 + 1]),
                           (rp[0], rp[1]), pes, n_processed, pi, rg_id)
            return
        # whole-batch fallback (rare: a read hit the worker1 gate) — fall
        # through to the region-marshaling path below

    if not pe and not (opt.flag & MEM_F_REF_HDR):
        # fused C++ worker1+worker2 (SAM text straight from the library)
        sams = nat.align_se_batch(opt, seqs, n_processed, rg_id, n_workers,
                                  inj=inj)
        for i, (s, sam) in enumerate(zip(seqs, sams)):
            if sam is not None:
                s.sam = sam
            else:
                regs = AlnRegs()
                if not (opt.parent & 1) or (opt.parent >> 1):
                    align1_core(opt, st, s, regs, 0)
                if not (opt.parent & 1) or not (opt.parent >> 1):
                    align1_core(opt, st, s, regs, 1)
                merge_regions(opt, st.idx, s.seq, s.l_seq, regs)
                worker2_se(opt, st, s, regs, n_processed, i, rg_id)
        return

    out, out_n = nat.worker1_batch(opt, seqs, opt.n_threads)
    use_pool = n_workers > 1 and len(seqs) >= 256
    if not use_pool:
        all_regs = nat.build_regs(opt, seqs, out, out_n, 0)
        if not pe:
            for i, s in enumerate(seqs):
                worker2_se(opt, st, s, all_regs[i], n_processed, i, rg_id)
        else:
            pes = pes0 if pes0 is not None else pestat(opt, st.idx, all_regs)
            for i in range(len(seqs) >> 1):
                worker2_pe(opt, st, (seqs[i << 1], seqs[(i << 1) | 1]),
                           (all_regs[i << 1], all_regs[(i << 1) | 1]), pes,
                           n_processed, i, rg_id)
        return

    import multiprocessing as mp
    ctx = mp.get_context("fork")
    step = max(64, (len(seqs) + 4 * n_workers - 1) // (4 * n_workers))
    if pe and step % 2:
        step += 1

    def chunk_args(lo):
        return (lo, seqs[lo:lo + step],
                out[lo * REG_CAP:(lo + len(seqs[lo:lo + step])) * REG_CAP],
                out_n[lo:lo + step])

    with ctx.Pool(n_workers, initializer=_w2_init,
                  initargs=(opt, st, rg_id)) as pool:
        if not pe:
            jobs = [chunk_args(lo) + (n_processed,)
                    for lo in range(0, len(seqs), step)]
            for lo, sams in pool.imap(_w2_se_chunk, jobs):
                for j, sam in enumerate(sams):
                    seqs[lo + j].sam = sam
        else:
            jobs = [chunk_args(lo) for lo in range(0, len(seqs), step)]
            all_regs: List[Optional[AlnRegs]] = [None] * len(seqs)
            for lo, regs_list in pool.imap(_pe_build_chunk, jobs):
                all_regs[lo:lo + len(regs_list)] = regs_list
            pes = pes0 if pes0 is not None else pestat(opt, st.idx, all_regs)
            jobs2 = [(lo >> 1, seqs[lo:lo + step], all_regs[lo:lo + step], pes,
                      n_processed)
                     for lo in range(0, len(seqs), step)]
            for lo_pair, sams in pool.imap(_w2_pe_chunk, jobs2):
                for j, (s1, s2) in enumerate(sams):
                    seqs[(lo_pair + j) * 2].sam = s1
                    seqs[(lo_pair + j) * 2 + 1].sam = s2
