"""Bisulfite reads of a deployment's library, drawn from its sample.

Provenance: a frozen, vectorised form of tools/make_testdata.py's read
pattern (a fragment drawn from the sample, converted per its strand, mate 1
from the 5' end of the converted strand and mate 2 reverse-complemented from
its 3' end, substitution errors), with a whole chunk's reads drawn at once,
base qualities and errors that rise along a read, methylation levels per
CpG, and MspI fragments for RRBS.

Reads come back with their truth: for every read its chromosome, the 0-based
reference coordinate of its forward (reference-strand) form's first aligned
base, whether it maps to the reverse strand, and the score of its true
alignment at its origin under biscuit's bisulfite scoring (`true_score`),
which the reference holds the aligner's primary alignment to.

A configuration may give its reads a cell barcode and a UMI (`barcode_len`,
`umi_len`, a pool of `n_barcodes` barcodes): each read's name then ends in
`_<barcode>_<umi>`, as `align -9` splits it, drawn from the seed apart from
the reads, so that the reads themselves are those of the same configuration
without the keys.
"""
from dataclasses import dataclass

import numpy as np

from .genome import ASCII, Genome

# biscuit align's documented scoring defaults (`biscuit align -h`): match A,
# mismatch B, gap open O and extension E; the reference's check reads them
# from here
MATCH, MISMATCH, GAP_OPEN, GAP_EXT = 1, 2, 6, 1
COMP = np.array([3, 2, 1, 0, 4], np.uint8)


def score_matrix(kind: str) -> np.ndarray:
    """5x5 scores, row the reference base, column the read base: A for an
    equal base, -B for another, -1 where either is N; `ct` also scores a
    read T over a reference C as A, `ga` a read A over a G."""
    m = np.full((5, 5), -1, np.int64)
    m[:4, :4] = -MISMATCH
    m[np.arange(4), np.arange(4)] = MATCH
    if kind == "ct":
        m[1, 3] = MATCH
    else:
        m[2, 0] = MATCH
    return m


SCORE = {"ct": score_matrix("ct"), "ga": score_matrix("ga")}


@dataclass
class Chunk:
    """One chunk of a FASTQ: reads in file order (mates interleaved)."""
    names: list
    seqs: list            # uint8 code arrays, the read as sequenced
    quals: list           # bytes, Phred+33
    chrom: np.ndarray     # int64, chromosome index
    pos: np.ndarray       # int64, 0-based start of the forward form
    rev: np.ndarray       # bool, maps to the reverse strand
    true_score: np.ndarray  # int64
    refpos: np.ndarray = None    # [n, L] reference coordinate of each
                                 # forward-form base, -1 inserted (pairs)
    fwd: np.ndarray = None       # [n, L] forward forms (pairs)
    fwd_quals: np.ndarray = None  # [n, L] their Phred+33 qualities
    ot: np.ndarray = None        # OT molecule
    lens: np.ndarray = None      # read lengths (rows of refpos, fwd and
                                 # fwd_quals are padded past them)
    tags: list = None            # (barcode, umi) of each read, or None

    @property
    def bases(self) -> int:
        return sum(len(s) for s in self.seqs)


def _convert(fwd: np.ndarray, ref_beta: np.ndarray, u: np.ndarray,
             ot: np.ndarray, cfg: dict) -> np.ndarray:
    """Bisulfite conversion of forward-form windows [n, L]: on an OT
    molecule each C is kept with its methylation level (a CpG's beta, else
    meth_cph) and else converted to T at the config's efficiency; on an OB
    molecule the same for each G (the C of the reverse strand), to A."""
    p = np.where(ref_beta > 0, ref_beta, np.float32(cfg["meth_cph"]))
    kept = u < p + (1 - p) * np.float32(1 - cfg["conversion"])
    out = fwd.copy()
    otm = ot[:, None]
    out[otm & (fwd == 1) & ~kept] = 3
    out[~otm & (fwd == 2) & ~kept] = 0
    return out


def _errors(reads: np.ndarray, lens: np.ndarray, rng, cfg: dict, scale: float):
    """Substitution errors at a rate rising from err_5p at a read's first
    base to err_3p (times `scale`) at its last, quadratically; and Phred+33
    qualities of those rates with +-3 of noise. Reads [n, L] in sequencing
    orientation, padded past `lens`."""
    n, L = reads.shape
    frac = np.arange(L)[None, :] / np.maximum(lens - 1, 1)[:, None]
    rate = scale * (cfg["err_5p"] + (cfg["err_3p"] - cfg["err_5p"]) * frac ** 2)
    hit = rng.random((n, L), dtype=np.float32) < rate
    out = reads.copy()
    out[hit] = (out[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    q = np.rint(-10 * np.log10(rate)) + rng.integers(-3, 4, (n, L))
    return out, (np.clip(q, 2, 41) + 33).astype(np.uint8)


def _hap_windows(g: Genome, h: np.ndarray, hstart: np.ndarray, L: int):
    """(codes, refpos) [n, L] of haplotype windows: haplotype h[i]'s bases
    from hstart[i], and each base's reference coordinate, -1 where it is
    inserted."""
    n = len(h)
    codes = np.empty((n, L), np.uint8)
    ref = np.empty((n, L), np.int32)
    j = np.arange(L)[None, :]
    for k in (0, 1):
        m = h == k
        if not m.any():
            continue
        idx = np.minimum(hstart[m][:, None] + j, len(g.keys[k]) - 1)
        key = g.keys[k][idx]
        prev = np.where(idx > 0, g.keys[k][np.maximum(idx - 1, 0)], -1)
        codes[m] = g.haps[k][idx]
        ref[m] = np.where(key == prev, -1, key)
    return codes, ref


def _ref_to_hap(g: Genome, h: np.ndarray, rpos: np.ndarray) -> np.ndarray:
    """The haplotype coordinate of each reference coordinate (the next kept
    base where it is deleted)."""
    out = np.empty(len(h), np.int64)
    for k in (0, 1):
        m = h == k
        out[m] = np.searchsorted(g.keys[k], rpos[m], side="left")
    return out


def _true_alignment(fwd: np.ndarray, ref: np.ndarray, g: Genome,
                    ot: np.ndarray, lens: np.ndarray):
    """(start, score) of forward forms at their origin: the first aligned
    base's reference coordinate, and the score of the true alignment
    (matches and mismatches under the strand's bisulfite scoring, each
    insertion run and each deletion an affine gap)."""
    live = np.arange(fwd.shape[1])[None, :] < lens[:, None]
    al = (ref >= 0) & live
    rb = g.codes[np.maximum(ref, 0)]
    s = np.where(ot[:, None], SCORE["ct"][rb, fwd], SCORE["ga"][rb, fwd])
    score = (s * al).sum(1, dtype=np.int64)
    ins = (ref < 0) & live
    runs = ins & ~np.concatenate([np.zeros((len(ins), 1), bool),
                                  ins[:, :-1]], 1)
    score -= GAP_OPEN * runs.sum(1) + GAP_EXT * ins.sum(1)
    last = np.maximum.accumulate(np.where(al, ref, -1), axis=1)
    prev = np.concatenate([np.full((len(ref), 1), -1), last[:, :-1]], 1)
    d = np.where(al & (prev >= 0), ref - prev - 1, 0)
    score -= GAP_OPEN * (d > 0).sum(1) + GAP_EXT * d.sum(1)
    start = np.where(al, ref, np.iinfo(ref.dtype).max).min(1).astype(np.int64)
    return start, score


def cigar_of(ref: np.ndarray) -> str:
    """The CIGAR of one window's reference coordinates (-1 inserted)."""
    ops = []
    prev = None
    for r in ref:
        if r < 0:
            op = "I"
        else:
            if prev is not None and r > prev + 1:
                ops.append(("D", r - prev - 1))
            prev, op = r, "M"
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + 1)
        else:
            ops.append((op, 1))
    return "".join(f"{n}{o}" for o, n in ops)


def _reverse_rows(a: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Each row's first lens[i] entries reversed, in place of the row's
    first lens[i] (the padding stays after them)."""
    j = np.arange(a.shape[1])[None, :]
    src = np.where(j < lens[:, None], lens[:, None] - 1 - j, j)
    return np.take_along_axis(a, src, 1)


def _revcomp_rows(a: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Each row's first lens[i] codes reverse-complemented, in place of
    the row's first lens[i] (the padding stays after them)."""
    out = _reverse_rows(a, lens)
    live = np.arange(a.shape[1])[None, :] < lens[:, None]
    return np.where(live, COMP[out], out)


def _chunk(names, reads, quals, lens, chrom, pos, rev, score) -> Chunk:
    seqs = [reads[i, :lens[i]] for i in range(len(lens))]
    qs = [quals[i, :lens[i]].tobytes() for i in range(len(lens))]
    return Chunk(names, seqs, qs, chrom, pos, rev, score)


def wgbs_pairs(g: Genome, cfg: dict, rng, n_pairs: int, tag: str,
               region=None) -> Chunk:
    """n_pairs directional WGBS pairs, mates interleaved (1, 2, 1, 2, ...),
    from anywhere in the genome or from fragments that overlap `region`,
    (chromosome, start, end) in reference coordinates."""
    L = cfg["read_len"]
    flen = np.clip(np.rint(rng.normal(cfg["frag_mean"], cfg["frag_sd"],
                                      n_pairs)), cfg["frag_min"],
                   cfg["frag_max"]).astype(np.int64)
    clen = np.diff(g.starts)
    if region is None:
        chrom = rng.choice(len(clen), n_pairs, p=clen / clen.sum())
        lo = np.zeros(n_pairs, np.int64)
        span = clen[chrom] - flen - 4 * cfg["indel_max"]
    else:
        chrom = np.full(n_pairs, region[0])
        lo = np.maximum(region[1] - flen, 0)
        span = np.minimum(region[2], clen[chrom] - flen - 4 * cfg[
            "indel_max"]) - lo
    rstart = g.starts[chrom] + lo + (rng.random(n_pairs) * span).astype(
        np.int64)
    ot = rng.random(n_pairs) < 0.5
    h = rng.integers(0, 2, n_pairs)
    hs = _ref_to_hap(g, h, rstart)
    u = rng.random((n_pairs, cfg["frag_max"]), dtype=np.float32)
    fw, rf = [], []
    for at, uoff in ((hs, np.zeros(n_pairs, np.int64)), (hs + flen - L,
                                                       flen - L)):
        codes, ref = _hap_windows(g, h, at, L)
        uw = np.take_along_axis(u, uoff[:, None] + np.arange(L)[None, :], 1)
        fw.append(_convert(codes, g.beta[np.maximum(ref, 0)] * (ref >= 0),
                           uw, ot, cfg))
        rf.append(ref)
    # mate 1 reads the converted strand from its 5' end: the left window on
    # OT, the right window reverse-complemented on OB; mate 2 the other
    lens = np.full(n_pairs, L)
    m1 = np.where(ot[:, None], fw[0], _revcomp_rows(fw[1], lens))
    m2 = np.where(ot[:, None], _revcomp_rows(fw[1], lens), fw[0])
    m1, q1 = _errors(m1, lens, rng, cfg, 1.0)
    m2, q2 = _errors(m2, lens, rng, cfg, cfg["err_r2_scale"])
    # forward forms after errors, and the truth of each mate
    f1 = np.where(ot[:, None], m1, _revcomp_rows(m1, lens))
    f2 = np.where(ot[:, None], _revcomp_rows(m2, lens), m2)
    r1 = np.where(ot[:, None], rf[0], rf[1])
    r2 = np.where(ot[:, None], rf[1], rf[0])
    p1, s1 = _true_alignment(f1, r1, g, ot, lens)
    p2, s2 = _true_alignment(f2, r2, g, ot, lens)
    reads = np.empty((2 * n_pairs, L), np.uint8)
    quals = np.empty_like(reads)
    reads[0::2], reads[1::2], quals[0::2], quals[1::2] = m1, m2, q1, q2
    inter = lambda a, b: np.stack([a, b], 1).reshape(-1)
    names = [f"{tag}.{i}" for i in range(n_pairs) for _ in (0, 1)]
    ch = _chunk(names, reads, quals, np.full(2 * n_pairs, L),
                inter(chrom, chrom), inter(p1, p2) - np.repeat(
                    g.starts[chrom], 2), inter(~ot, ot), inter(s1, s2))
    ch.refpos = np.stack([r1, r2], 1).reshape(2 * n_pairs, L)
    ch.fwd = np.stack([f1, f2], 1).reshape(2 * n_pairs, L)
    ch.fwd_quals = np.stack([np.where(ot[:, None], q1, q1[:, ::-1]),
                             np.where(ot[:, None], q2[:, ::-1], q2)],
                            1).reshape(2 * n_pairs, L)
    ch.ot = np.repeat(ot, 2)
    ch.lens = np.full(2 * n_pairs, L)
    return ch


def mspi_fragments(g: Genome, cfg: dict):
    """(start, length) of the reference's MspI fragments (C^CGG) within
    each chromosome, kept at frag_min-frag_max bp."""
    c = g.codes
    site = np.nonzero((c[:-3] == 1) & (c[1:-2] == 1) & (c[2:-1] == 2)
                      & (c[3:] == 2))[0] + 1
    a, b = site[:-1], site[1:]
    same = g.chrom_of(a) == g.chrom_of(b - 1)
    ln = b - a
    keep = same & (ln >= cfg["frag_min"]) & (ln <= cfg["frag_max"])
    return a[keep], ln[keep]


def rrbs_reads(g: Genome, cfg: dict, frags, rng, n_reads: int,
               tag: str) -> Chunk:
    """n_reads directional RRBS reads: a fragment, a haplotype and a strand
    drawn uniformly, the converted strand read from its 5' end for
    min(length, read_len) bases."""
    L = cfg["read_len"]
    fa, fl = frags
    k = rng.integers(0, len(fa), n_reads)
    h = rng.integers(0, 2, n_reads)
    hs = _ref_to_hap(g, h, fa[k])
    he = _ref_to_hap(g, h, fa[k] + fl[k])
    lens = np.minimum(he - hs, L)
    ot = rng.random(n_reads) < 0.5
    codes, ref = _hap_windows(g, h, np.where(ot, hs, he - lens), L)
    u = rng.random((n_reads, L), dtype=np.float32)
    fwd = _convert(codes, g.beta[np.maximum(ref, 0)] * (ref >= 0), u, ot, cfg)
    seq = np.where(ot[:, None], fwd, _revcomp_rows(fwd, lens))
    seq, q = _errors(seq, lens, rng, cfg, 1.0)
    f = np.where(ot[:, None], seq, _revcomp_rows(seq, lens))
    start, s = _true_alignment(f, ref, g, ot, lens)
    chrom = g.chrom_of(start)
    names = [f"{tag}.{i}" for i in range(n_reads)]
    ch = _chunk(names, seq, q, lens, chrom, start - g.starts[chrom], ~ot, s)
    ch.refpos, ch.fwd, ch.ot, ch.lens = ref, f, ot, lens
    ch.fwd_quals = np.where(ot[:, None], q, _reverse_rows(q, lens))
    return ch


def _tag_reads(chunk: Chunk, cfg: dict, seed: int, c: int) -> None:
    """Give the chunk's reads the configuration's barcodes and UMIs, if it
    has them: a barcode from the run's pool of n_barcodes and a UMI for
    each read (mates share both), appended to its name."""
    if not {"barcode_len", "umi_len", "n_barcodes"} & set(cfg):
        return
    rng = np.random.default_rng([seed, 17])
    acgt = np.frombuffer(b"ACGT", np.uint8)
    pool = acgt[rng.integers(0, 4, (cfg["n_barcodes"], cfg["barcode_len"]))]
    rng = np.random.default_rng([seed, 17, c])
    mols = len(chunk.names) // 2 if cfg["layout"] == "pe" else \
        len(chunk.names)
    bc = pool[rng.integers(0, len(pool), mols)]
    umi = acgt[rng.integers(0, 4, (mols, cfg["umi_len"]))]
    tags = [(b.tobytes().decode(), u.tobytes().decode())
            for b, u in zip(bc, umi)]
    if cfg["layout"] == "pe":
        tags = [t for t in tags for _ in (0, 1)]
    chunk.tags = tags
    chunk.names = [f"{n}_{b}_{u}" for n, (b, u) in zip(chunk.names, tags)]


def make_chunks(g: Genome, cfg: dict, seed: int, n_chunks: int,
                chunk_bases: int):
    """The run's pool of chunks: each exactly the records that read_batch
    takes as one batch of chunk_bases (it stops at the first even count of
    records whose bases reach it)."""
    rng = np.random.default_rng([seed, 7])
    out = []
    frags = mspi_fragments(g, cfg) if cfg["rrbs"] else None
    for c in range(n_chunks):
        tag = f"s{seed % 100000}c{c}"
        if cfg["layout"] == "pe":
            out.append(wgbs_pairs(g, cfg, rng, -(-chunk_bases // (2 * cfg[
                "read_len"])), tag))
        else:
            mean = np.minimum(frags[1], cfg["read_len"]).mean()
            ch = rrbs_reads(g, cfg, frags, rng,
                            int(1.05 * chunk_bases / mean) + 64, tag)
            total = np.cumsum([len(s) for s in ch.seqs])
            k = int(np.searchsorted(total, chunk_bases)) + 1
            k += k % 2
            out.append(Chunk(ch.names[:k], ch.seqs[:k], ch.quals[:k],
                             ch.chrom[:k], ch.pos[:k], ch.rev[:k],
                             ch.true_score[:k]))
        _tag_reads(out[-1], cfg, seed, c)
    return out


def write_fastq(chunk: Chunk, paths) -> None:
    """The chunk as FASTQ: one file (SE) or mates 1 and 2 apart (PE)."""
    files = [open(p, "wb") for p in paths]
    try:
        for i, (name, s, q) in enumerate(zip(chunk.names, chunk.seqs,
                                             chunk.quals)):
            files[i % len(files)].write(b"@%s\n%s\n+\n%s\n" % (
                name.encode(), ASCII[s].tobytes(), q))
    finally:
        for f in files:
            f.close()


def _true_records(g: Genome, ch: Chunk, c0: int):
    """(CIGAR, 0-based position on the chromosome starting at c0, NM) of
    each read of `ch` at its true alignment, leading and trailing
    insertions soft-clipped."""
    cig, pos = [], []
    for i, n in enumerate(ch.lens):
        r = ch.refpos[i, :n]
        if r[0] >= 0 and r[-1] - r[0] == n - 1:
            cig.append([("M", int(n))])
        else:
            ops = [(o, int(k)) for k, o in
                   _split_cigar(cigar_of(r))]
            if ops[0][0] == "I":
                ops[0] = ("S", ops[0][1])
            if ops[-1][0] == "I":
                ops[-1] = ("S", ops[-1][1])
            cig.append(ops)
        pos.append(int(r[r >= 0][0]) - c0)
    in_read = np.arange(ch.refpos.shape[1])[None, :] < ch.lens[:, None]
    live = (ch.refpos >= 0) & in_read
    rb = g.codes[np.maximum(ch.refpos, 0)]
    conv = np.where(ch.ot[:, None], (ch.fwd == 3) & (rb == 1),
                    (ch.fwd == 0) & (rb == 2))
    nm = ((ch.fwd != rb) & live & ~conv).sum(1) + (~live & in_read).sum(1)
    nm = [int(k) + sum(m for o, m in c if o == "D") for k, c in zip(nm, cig)]
    return cig, pos, nm


def pileup_records(g: Genome, cfg: dict, region, depth: float, seed: int,
                   tag: str):
    """A sample's alignments over `region` (chromosome, start, end) at
    `depth`, as biscuit would write them for the configuration's library,
    each read at its true alignment (leading and trailing insertions soft-
    clipped), MAPQ 60, NM, AS (the true alignment's score) and YD, sorted
    by position. Returns gen.bam.Record's.

    WGBS (`rrbs` 0): directional pairs from fragments that overlap the
    region, at `depth` over it, with proper-pair flags, mate fields and MC.
    RRBS (`rrbs` 1): single-end reads drawn as rrbs_reads draws them from
    the MspI fragments that lie wholly inside the region, as many as give
    `depth` over the fragments' bases; flags 0 or 16, no mate."""
    rng = np.random.default_rng([seed, 13])
    if cfg["rrbs"]:
        return _rrbs_records(g, cfg, region, depth, rng, tag)
    from .bam import Record
    L = cfg["read_len"]
    n_pairs = int(depth * (region[2] - region[1]) / (2 * L))
    ch = wgbs_pairs(g, cfg, rng, n_pairs, tag, region)
    cig, pos, nm = _true_records(g, ch, g.starts[region[0]])
    recs = []
    for i in range(2 * n_pairs):
        j = i ^ 1
        rev = bool(ch.rev[i])
        flag = 0x1 | 0x2 | (0x10 if rev else 0) | (0x20 if ch.rev[j] else 0) \
            | (0x40 if i % 2 == 0 else 0x80)
        lo = min(pos[i], pos[j])
        hi = max(pos[k] + sum(n for o, n in cig[k] if o in "MD")
                 for k in (i, j))
        recs.append(Record(
            ch.names[i], flag, region[0], pos[i], 60, cig[i], region[0],
            pos[j], (hi - lo) * (-1 if rev else 1), ch.fwd[i],
            ch.fwd_quals[i].tobytes(),
            [("NM", "i", nm[i]), ("AS", "i", int(ch.true_score[i])),
             ("MC", "Z", "".join(f"{n}{o}" for o, n in cig[j])),
             ("YD", "A", "f" if ch.ot[i] else "r")]))
    recs.sort(key=lambda r: r.pos)
    return recs


def _rrbs_records(g: Genome, cfg: dict, region, depth: float, rng,
                  tag: str):
    from .bam import Record
    fa, fl = mspi_fragments(g, cfg)
    c0 = g.starts[region[0]]
    hi = c0 + min(region[2], g.starts[region[0] + 1] - c0)
    inside = (fa >= c0 + region[1]) & (fa + fl <= hi)
    fa, fl = fa[inside], fl[inside]
    if not len(fa):
        raise ValueError(f"no MspI fragment of {cfg['frag_min']}-"
                         f"{cfg['frag_max']} bp lies inside {region}")
    n = int(depth * fl.sum() / np.minimum(fl, cfg["read_len"]).mean())
    ch = rrbs_reads(g, cfg, (fa, fl), rng, n, tag)
    cig, pos, nm = _true_records(g, ch, c0)
    recs = []
    for i in range(n):
        k = ch.lens[i]
        recs.append(Record(
            ch.names[i], 0x10 if ch.rev[i] else 0, region[0], pos[i], 60,
            cig[i], -1, -1, 0, ch.fwd[i, :k], ch.fwd_quals[i, :k].tobytes(),
            [("NM", "i", nm[i]),
             ("AS", "i", int(ch.true_score[i])),
             ("YD", "A", "f" if ch.ot[i] else "r")]))
    recs.sort(key=lambda r: r.pos)
    return recs


def _split_cigar(s: str):
    out, num = [], ""
    for ch in s:
        if ch.isdigit():
            num += ch
        else:
            out.append((num, ch))
            num = ""
    return out
