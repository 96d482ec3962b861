"""TPU-friendly FM-index arrays + (de)serialization.

The reference interleaves occ checkpoints and BWT words in one 512-bit unit
(lib/aln/bwt.h:48-101). For TPU we instead keep two flat
gather-friendly arrays:

  words  : uint32[n_words]  2-bit BWT chars, base i at shift ((15-(i&15))*2)
  occ_cp : uint32[n_blocks+1, 4]  counts of each base in bwt[0 : 128*b)

plus L2 (cumulative base counts), primary (rank of the removed '$' row) and a
sampled suffix array every 32 ranks — identical values to the reference's
bwt_t, verified against its on-disk .bwt/.sa files in tests.

Strands below 2^31 chars use the compact uint32 SA-sample layout (with the
'$' row stored as the uint32 wrap of -1); larger strands (human-scale doubled
genomes) switch to int64 samples automatically (index_is_wide) and run on the
native/host engines. BISCUIT_TPU_WIDE_INDEX=1 forces the wide layout so the
big-genome path is testable on small data.

Copy of biscuit_tpu/index/fmindex.py: the code is the source's, so that the port
imports nothing of the JAX package; tests/test_torch_engine.py holds the
copy to its source.
"""
from dataclasses import dataclass
from typing import Dict, List

import json
import numpy as np

from .fasta import Ann, Amb, PackedGenome, pack_2bit, unpack_2bit

OCC_INTERVAL = 128
SA_INTERVAL = 32  # the REFERENCE's .sa sampling (bwt.c); imports use this


def default_sa_intv(wide: bool = False) -> int:
    """SA sampling interval for indexes WE build (BISCUIT_TPU_SA_INTV).

    The reference fixes 32 (avg 16 invPsi steps per lookup). SA walks are
    the hottest stage at genome scale (35% of align time at 50 Mbp, worse
    at human scale), and sampling density is a pure speed/size dial: the
    resolved positions are exact either way, so output parity is unaffected.
    Measured at 50 Mbp / -@4 (CPU-seconds, contention-resistant): intv 8
    cut sa_walk 3.1x (1.6x whole-align wall); intv 4 a further ~1.36x of
    align CPU time. Narrow default 4 = avg 1.5 steps, 1 B/char of sample
    bytes (the whole narrow index is ~1.5 B/char, bwa-mem2-class sizes);
    wide (int64-sample, >=2^31-char) strands default 16 to bound the extra
    bytes at human scale (0.5 GB/Gchar). Must be a power of two <= 32 so
    reference-format exports can stride-subsample."""
    import os
    v = os.environ.get("BISCUIT_TPU_SA_INTV")
    v = int(v) if v else (16 if wide else 4)
    assert v in (1, 2, 4, 8, 16, 32), "BISCUIT_TPU_SA_INTV must be 2^k <= 32"
    return v


@dataclass
class StrandIndex:
    """FM-index over one converted doubled genome (parent or daughter)."""
    words: np.ndarray      # uint32[n_words]
    occ_cp: np.ndarray     # uint32[n_blocks+1, 4]
    L2: np.ndarray         # int64[5] cumulative: 0, #A, #A+#C, ...
    primary: int
    seq_len: int
    sa_samples: np.ndarray  # uint32[n_sa], rank k*sa_intv -> text pos; [0] unused
    sa_intv: int = 32       # sampling interval (reference format: 32; ours: 8)

    def bwt_char(self, k: int) -> int:
        """BWT char at $-removed position k (debug/host path)."""
        return int(self.words[k >> 4] >> ((~k & 15) << 1) & 3)


@dataclass
class BisIndex:
    """Complete biscuit_tpu index: parent (C->T) + daughter (G->A) strand
    FM-indexes, unconverted forward pac, and contig annotations."""
    par: StrandIndex
    dau: StrandIndex
    pac: np.ndarray        # uint8[l_pac] unconverted forward codes 0..3
    anns: List[Ann]
    ambs: List[Amb]
    l_pac: int
    # set when loaded from the mmap layout; derived caches (e.g. the native
    # engine's interleaved occ blocks) persist here for instant re-use
    mmap_dir: str = None

    def save(self, prefix: str) -> None:
        meta = {
            "l_pac": self.l_pac,
            "anns": [vars(a) for a in self.anns],
            "ambs": [vars(a) for a in self.ambs],
            "version": 1,
        }
        arrays: Dict[str, np.ndarray] = {"pac": pack_2bit(self.pac)}
        for tag, s in (("par", self.par), ("dau", self.dau)):
            arrays[f"{tag}_words"] = s.words
            arrays[f"{tag}_occ"] = s.occ_cp
            arrays[f"{tag}_L2"] = s.L2
            arrays[f"{tag}_primary"] = np.int64(s.primary)
            arrays[f"{tag}_seq_len"] = np.int64(s.seq_len)
            arrays[f"{tag}_sa"] = s.sa_samples
            arrays[f"{tag}_sa_intv"] = np.int64(s.sa_intv)
        np.savez(prefix + ".btidx.npz", **arrays)
        with open(prefix + ".btidx.json", "w") as f:
            json.dump(meta, f)

    def save_mmap(self, prefix: str) -> None:
        """Write the memory-mappable index layout: one raw .npy per array in
        `<prefix>.btidx/` (pac stored unpacked). The bwashm equivalent
        (lib/aln/bwashm.c): load() maps these pages read-only, so start-up
        is instant and concurrent processes share one physical copy."""
        import os

        d = prefix + ".btidx"
        os.makedirs(d, exist_ok=True)
        # Drop derived caches (e.g. {par,dau}_ilv2.npy interleaved occ blocks
        # written lazily by the native engine): rebuilding over an existing
        # dir must not let a same-size stale cache masquerade as current.
        import glob
        for stale in glob.glob(os.path.join(d, "*_ilv2.npy")):
            try:
                os.unlink(stale)
            except OSError:
                pass
        meta = {
            "l_pac": self.l_pac,
            "anns": [vars(a) for a in self.anns],
            "ambs": [vars(a) for a in self.ambs],
            "version": 1,
            "par_primary": int(self.par.primary),
            "par_seq_len": int(self.par.seq_len),
            "dau_primary": int(self.dau.primary),
            "dau_seq_len": int(self.dau.seq_len),
            "par_sa_intv": int(self.par.sa_intv),
            "dau_sa_intv": int(self.dau.sa_intv),
        }
        np.save(os.path.join(d, "pac.npy"), np.ascontiguousarray(self.pac))
        for tag, s in (("par", self.par), ("dau", self.dau)):
            np.save(os.path.join(d, f"{tag}_words.npy"), s.words)
            np.save(os.path.join(d, f"{tag}_occ.npy"), s.occ_cp)
            np.save(os.path.join(d, f"{tag}_L2.npy"), s.L2)
            np.save(os.path.join(d, f"{tag}_sa.npy"), s.sa_samples)
        with open(os.path.join(d, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def _load_mmap(cls, prefix: str) -> "BisIndex":
        import os

        d = prefix + ".btidx"
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        m = lambda n: np.load(os.path.join(d, n), mmap_mode="r")
        strands = {}
        for tag in ("par", "dau"):
            strands[tag] = StrandIndex(
                words=m(f"{tag}_words.npy"),
                occ_cp=m(f"{tag}_occ.npy"),
                L2=np.asarray(m(f"{tag}_L2.npy")),
                primary=meta[f"{tag}_primary"],
                seq_len=meta[f"{tag}_seq_len"],
                sa_samples=m(f"{tag}_sa.npy"),
                sa_intv=int(meta.get(f"{tag}_sa_intv", 32)),
            )
        return cls(
            par=strands["par"],
            dau=strands["dau"],
            pac=m("pac.npy"),
            anns=[Ann(**a) for a in meta["anns"]],
            ambs=[Amb(**a) for a in meta["ambs"]],
            l_pac=meta["l_pac"],
            mmap_dir=d,
        )

    @classmethod
    def load(cls, prefix: str) -> "BisIndex":
        import os

        if os.path.isdir(prefix + ".btidx"):
            return cls._load_mmap(prefix)
        z = np.load(prefix + ".btidx.npz")
        with open(prefix + ".btidx.json") as f:
            meta = json.load(f)
        strands = {}
        for tag in ("par", "dau"):
            strands[tag] = StrandIndex(
                words=z[f"{tag}_words"],
                occ_cp=z[f"{tag}_occ"],
                L2=z[f"{tag}_L2"],
                primary=int(z[f"{tag}_primary"]),
                seq_len=int(z[f"{tag}_seq_len"]),
                sa_samples=z[f"{tag}_sa"],
                sa_intv=(int(z[f"{tag}_sa_intv"])
                         if f"{tag}_sa_intv" in z.files else 32),
            )
        l_pac = meta["l_pac"]
        return cls(
            par=strands["par"],
            dau=strands["dau"],
            pac=unpack_2bit(z["pac"], l_pac),
            anns=[Ann(**a) for a in meta["anns"]],
            ambs=[Amb(**a) for a in meta["ambs"]],
            l_pac=l_pac,
        )


# chunk size for the streaming packers below: bounds transient memory at
# ~24 bytes/char over 64M chars (~1.5 GB) regardless of strand length, so
# human-scale strands (6.2 G chars) assemble without O(16n) temporaries.
_PACK_CHUNK = 64 * 1024 * 1024  # chars; multiple of 16 and OCC_INTERVAL


def pack_words(bwt_codes: np.ndarray) -> np.ndarray:
    """Pack uint8 BWT codes into uint32 words, base i at shift (15-(i&15))*2
    (same in-word layout as the reference so occ popcount tricks match)."""
    n = len(bwt_codes)
    n_words = (n + 15) // 16
    out = np.zeros(n_words, dtype=np.uint32)
    shifts = np.arange(15, -1, -1, dtype=np.uint32) * 2
    for lo in range(0, n, _PACK_CHUNK):
        hi = min(lo + _PACK_CHUNK, n)
        m = hi - lo
        padded = np.zeros((m + 15) // 16 * 16, dtype=np.uint32)
        padded[:m] = bwt_codes[lo:hi]
        lanes = padded.reshape(-1, 16)
        out[lo // 16:lo // 16 + lanes.shape[0]] = \
            (lanes << shifts[None, :]).sum(axis=1, dtype=np.uint32)
    return out


def occ_checkpoints(bwt_codes: np.ndarray) -> np.ndarray:
    """occ_cp[b, c] = count of base c in bwt[0 : 128*b), one extra row at the
    end holding the totals."""
    n = len(bwt_codes)
    n_blocks = (n + OCC_INTERVAL - 1) // OCC_INTERVAL
    cp = np.zeros((n_blocks + 1, 4), dtype=np.uint64)
    for lo in range(0, n, _PACK_CHUNK):
        hi = min(lo + _PACK_CHUNK, n)
        chunk = bwt_codes[lo:hi]
        nb = (len(chunk) + OCC_INTERVAL - 1) // OCC_INTERVAL
        padded = np.full(nb * OCC_INTERVAL, 4, dtype=np.uint8)
        padded[:len(chunk)] = chunk
        blocks = padded.reshape(nb, OCC_INTERVAL)
        per_block = np.stack(
            [(blocks == c).sum(axis=1, dtype=np.uint64) for c in range(4)],
            axis=1)
        b0 = lo // OCC_INTERVAL
        cp[b0 + 1:b0 + 1 + nb] = per_block
    np.cumsum(cp, axis=0, out=cp)
    # counts of a >=2^32-char strand overflow uint32; wide strands store
    # int64 checkpoints (readers keep the stored dtype, ops widen on use)
    return cp.astype(np.uint32 if n < (1 << 32) else np.int64)


def index_is_wide(seq_len: int) -> bool:
    """Whether a strand of this length needs 64-bit SA samples (the uint32 +
    int32-wrap layout is valid below 2^31). BISCUIT_TPU_WIDE_INDEX=1 forces
    the wide layout so small-genome tests can exercise the big-genome path."""
    import os
    if os.environ.get("BISCUIT_TPU_WIDE_INDEX") == "1":
        return True
    return seq_len >= (1 << 31) - 1024


def build_strand_index_from_parts(words: np.ndarray, occ_cp_u64: np.ndarray,
                                  primary: int, seq_len: int,
                                  sa_samples_i64: np.ndarray,
                                  sa_intv: int) -> StrandIndex:
    """Assemble a StrandIndex from pre-built artifacts (the semi-external
    bwt_merge path, native/bwt_merge.cpp) — no full SA, no uint8 BWT codes.
    Dtype conventions match build_strand_index: uint32 checkpoints below
    2^32 chars, uint32 SA samples with the 0xFFFFFFFF sentinel below 2^31."""
    totals = occ_cp_u64[-1].astype(np.int64)
    L2 = np.zeros(5, dtype=np.int64)
    L2[1:] = np.cumsum(totals)
    # wide strands keep 64-bit checkpoints: view, don't copy (1.55 GB at
    # the human strand); counts never reach 2^63 so the reinterpret is safe
    occ_cp = (occ_cp_u64.view(np.int64) if seq_len >= (1 << 32)
              else occ_cp_u64.astype(np.uint32))
    if index_is_wide(seq_len):
        sa_samples = sa_samples_i64
    else:
        sa_samples = sa_samples_i64.astype(np.int64).astype(np.uint32)
        sa_samples[0] = np.uint32(0xFFFFFFFF)
    return StrandIndex(
        words=words,
        occ_cp=occ_cp,
        L2=L2,
        primary=primary,
        seq_len=seq_len,
        sa_samples=sa_samples,
        sa_intv=sa_intv,
    )


def build_strand_index(doubled_codes: np.ndarray, sa: np.ndarray, bwt_codes: np.ndarray,
                       primary: int) -> StrandIndex:
    """Assemble a StrandIndex from a suffix array + $-removed BWT codes."""
    n = len(doubled_codes)
    counts = np.bincount(doubled_codes, minlength=4)[:4]
    L2 = np.zeros(5, dtype=np.int64)
    L2[1:] = np.cumsum(counts)
    # sampled SA in the reference rank convention: full-matrix rank k in
    # [0, n]; rank 0 is the '$' row (text pos n, stored as sentinel -1);
    # rank k>=1 -> SA[k-1]. Samples at ranks k % sa_intv == 0 (the reference
    # fixes 32; ours defaults denser — see default_sa_intv).
    # Genomes whose doubled strand exceeds 2^31 chars (e.g. human) use int64
    # samples with a literal -1 sentinel instead of the uint32 wrap.
    intv = default_sa_intv(wide=index_is_wide(n))
    n_sa = (n + intv) // intv
    ranks = np.arange(1, n_sa) * intv
    if index_is_wide(n):
        sa_samples = np.empty(n_sa, dtype=np.int64)
        sa_samples[0] = -1
        sa_samples[1:] = sa[ranks - 1].astype(np.int64)
    else:
        sa_samples = np.empty(n_sa, dtype=np.uint32)
        sa_samples[0] = np.uint32(0xFFFFFFFF)
        sa_samples[1:] = sa[ranks - 1].astype(np.uint32)
    return StrandIndex(
        words=pack_words(bwt_codes),
        occ_cp=occ_checkpoints(bwt_codes),
        L2=L2,
        primary=primary,
        seq_len=n,
        sa_samples=sa_samples,
        sa_intv=intv,
    )


# ---------------------------------------------------------------------------
# Readers for the REFERENCE on-disk index formats — used by parity tests to
# compare against oracle-built artifacts, and to import existing indexes.
# Formats: bwt_dump_bwt / bwt_dump_sa (lib/aln/bwt.c:402-422),
# occ-interleaved layout bwt_bwtupdate_core (bwtindex.c:130-154).
# ---------------------------------------------------------------------------

def read_reference_bwt(path: str) -> StrandIndex:
    raw = np.fromfile(path, dtype=np.uint8)
    primary = int(np.frombuffer(raw[:8], dtype=np.uint64)[0])
    L2 = np.zeros(5, dtype=np.int64)
    L2[1:] = np.frombuffer(raw[8:40], dtype=np.uint64).astype(np.int64)
    seq_len = int(L2[4])
    body = np.frombuffer(raw[40:], dtype=np.uint32)
    # interleaved: per 128-base block, 8 words occ (4 x uint64 LE) then up to
    # 8 words of BWT chars; a trailing 8-word occ entry closes the stream.
    n_blocks = (seq_len + OCC_INTERVAL - 1) // OCC_INTERVAL
    n_words_total = (seq_len + 15) // 16
    words = np.empty(n_words_total, dtype=np.uint32)
    occ_cp = np.empty((n_blocks + 1, 4), dtype=np.uint32)
    pos = 0
    wpos = 0
    for b in range(n_blocks):
        occ_cp[b] = body[pos:pos + 8].view(np.uint64).astype(np.uint32)
        pos += 8
        nw = min(8, n_words_total - wpos)
        words[wpos:wpos + nw] = body[pos:pos + nw]
        pos += nw
        wpos += nw
    occ_cp[n_blocks] = body[pos:pos + 8].view(np.uint64).astype(np.uint32)
    n_sa = (seq_len + SA_INTERVAL) // SA_INTERVAL
    return StrandIndex(words=words, occ_cp=occ_cp, L2=L2, primary=primary,
                       seq_len=seq_len,
                       sa_samples=np.zeros(n_sa, dtype=np.uint32))


def read_reference_sa(path: str, idx: StrandIndex) -> None:
    """Fill idx.sa_samples from a reference .sa file (bwt_dump_sa layout)."""
    raw = np.fromfile(path, dtype=np.uint64)
    primary, sa_intv, seq_len = int(raw[0]), int(raw[5]), int(raw[6])
    assert primary == idx.primary, "SA-BWT inconsistency: primary mismatch"
    assert sa_intv == SA_INTERVAL
    assert seq_len == idx.seq_len
    vals = raw[7:]
    idx.sa_intv = SA_INTERVAL  # reference files always sample every 32
    if index_is_wide(seq_len):
        # human-scale strand: int64 samples with a literal -1 sentinel
        # (uint32 wrap would silently truncate positions >= 2^32)
        idx.sa_samples = np.empty(len(vals) + 1, dtype=np.int64)
        idx.sa_samples[0] = -1
        idx.sa_samples[1:] = vals.astype(np.int64)
    else:
        idx.sa_samples = np.empty(len(vals) + 1, dtype=np.uint32)
        idx.sa_samples[0] = np.uint32(0xFFFFFFFF)
        idx.sa_samples[1:] = vals.astype(np.uint32)


def read_reference_ann(prefix: str):
    """Parse .bis.ann/.bis.amb (bis_bns_dump, bntseq.c:509-540)."""
    anns: List[Ann] = []
    ambs: List[Amb] = []
    with open(prefix + ".bis.ann") as f:
        l_pac, n_seqs, _seed = [int(x) for x in f.readline().split()]
        for _ in range(n_seqs):
            parts = f.readline().rstrip("\n").split(" ", 2)
            gi, name = int(parts[0]), parts[1]
            anno = parts[2] if len(parts) > 2 else ""
            off, ln, namb = [int(x) for x in f.readline().split()]
            anns.append(Ann(name, anno, off, ln, namb, gi))
    with open(prefix + ".bis.amb") as f:
        _l, _n, n_holes = [int(x) for x in f.readline().split()]
        for _ in range(n_holes):
            off, ln, ch = f.readline().split()
            ambs.append(Amb(int(off), int(ln), ch))
    return l_pac, anns, ambs


# ---------------------------------------------------------------------------
# The port's own addition (the code above is the source's): an index from
# plain arrays, so that state made elsewhere (the JAX package's BisIndex, in
# the tests) crosses over as numpy arrays and Python values, never as an
# object of another package's class.
# ---------------------------------------------------------------------------

def bisindex_from_numpy(par: dict, dau: dict, pac: np.ndarray, anns, ambs,
                        l_pac: int) -> BisIndex:
    """A BisIndex from plain fields. `par` and `dau` map the StrandIndex
    field names (words, occ_cp, L2, primary, seq_len, sa_samples, sa_intv)
    to numpy arrays and ints; `anns` and `ambs` are sequences of dicts of
    the Ann and Amb fields."""
    def strand(f: dict) -> StrandIndex:
        return StrandIndex(
            words=np.asarray(f["words"]), occ_cp=np.asarray(f["occ_cp"]),
            L2=np.asarray(f["L2"]), primary=int(f["primary"]),
            seq_len=int(f["seq_len"]), sa_samples=np.asarray(f["sa_samples"]),
            sa_intv=int(f["sa_intv"]))
    return BisIndex(par=strand(par), dau=strand(dau), pac=np.asarray(pac),
                    anns=[Ann(**a) for a in anns],
                    ambs=[Amb(**a) for a in ambs], l_pac=int(l_pac))
