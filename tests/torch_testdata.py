"""Oracle-free test data for the torch port's tests.

`make_dataset` runs tools/make_testdata.py and builds the index next to
the FASTA with the port's own build_index(fa, prefix=fa), so both
the in-process engines and the `align` CLI find it. The conftest
`small_dataset` fixture also needs the reference oracle binary; these tests
do not. This module imports nothing of the JAX package at the top: the
bring-up check on the card uses it too. A test that holds the port against
the JAX package gives each side an index, options and reads of that side's
own classes: `port_index` and `jax_index` carry an index across as plain
numpy arrays and Python values.
"""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_dataset(d, genome_size=60000, n_reads=150, n_chroms=2, seed=11,
                 read_len=None, snp_rate=None, indel_every=0, pe=False,
                 index=True):
    """Writes genome.fa, its index and reads.fq into directory `d`; returns
    (fasta path, reads path, the in-memory BisIndex). indel_every=k puts a
    small deletion or insertion into two reads of every k (the generator
    makes none), so that global alignment and its traceback have work.
    pe=True writes n_reads pairs instead, and the reads path is the pair
    (reads_1.fq, reads_2.fq). index=False builds no index (None)."""
    from biscuit_tpu_torch.index.build import build_index
    args = [sys.executable, os.path.join(REPO, "tools", "make_testdata.py"),
            str(d), "--genome-size", str(genome_size), "--n-reads",
            str(n_reads), "--n-chroms", str(n_chroms), "--seed", str(seed)]
    if read_len is not None:
        args += ["--read-len", str(read_len)]
    if snp_rate is not None:
        args += ["--snp-rate", str(snp_rate)]
    if pe:
        args.append("--pe")
    subprocess.run(args, check=True, capture_output=True)
    if pe:
        fq = tuple(os.path.join(str(d), f"reads_{k}.fq") for k in (1, 2))
    else:
        fq = os.path.join(str(d), "reads.fq")
    if indel_every:
        for f in (fq if pe else (fq,)):
            add_indels(f, indel_every, seed)
    fa = os.path.join(str(d), "genome.fa")
    idx = build_index(fa, prefix=fa) if index else None
    return fa, fq, idx


# the environment switches of both packages' CLIs: a CLI test clears them,
# so that each run names its own
SWITCHES = ("BISCUIT_TPU_PILEUP", "BISCUIT_TPU_STREAMS",
            "BISCUIT_TPU_TORCH_PILEUP", "BISCUIT_TPU_TORCH_STREAMS",
            "BISCUIT_TPU_INDEX_SHARD", "BISCUIT_TPU_TORCH_INDEX_SHARD")


def cli_env(**more):
    """The environment of a CLI subprocess: the port's plain versions on the
    CPU, one intra-op thread, no switch of SWITCHES unless `more` names it."""
    env = {k: v for k, v in os.environ.items() if k not in SWITCHES}
    env["BISCUIT_TPU_TORCH_DEVICE"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    env.update(more)
    return env


def run_cli(pkg, argv, rc=0, **env):
    """`python -m <pkg>.cli <argv>` from the repository's root under
    cli_env(**env); its exit code must be `rc`. The CompletedProcess, in
    text."""
    r = subprocess.run([sys.executable, "-m", pkg + ".cli", *argv], cwd=REPO,
                       env=cli_env(**env), capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == rc, (pkg, argv, r.stderr[-3000:])
    return r


def tree_files(root):
    """{path under root: bytes} of every file there, a .gz file
    decompressed (gzip's header holds the time it was written)."""
    import gzip
    got = {}
    for top, _dirs, names in os.walk(root):
        for n in names:
            path = os.path.join(top, n)
            with (gzip.open if n.endswith(".gz") else open)(path, "rb") as f:
                got[os.path.relpath(path, root)] = f.read()
    return got


def diploid_dataset(d, n_reads, snp_rate, pe=False, index=True, **kw):
    """A diploid sample of make_dataset's genome in directory `d`: the first
    half of n_reads (pairs with pe=True) from its haplotype with SNPs at
    snp_rate, the other half from the reference (the same seed: the same
    genome), in one FASTQ (or one pair) with the names of each half
    prefixed `snp` and `ref`, so that every SNP is heterozygous and `asm`
    has two alleles to test. kw: make_dataset's other arguments. Returns
    what make_dataset returns."""
    fa, fq, idx = make_dataset(d, n_reads=n_reads - n_reads // 2,
                               snp_rate=snp_rate, pe=pe, index=index, **kw)
    _fa, ref_fq, _ = make_dataset(os.path.join(str(d), "ref"),
                                  n_reads=n_reads // 2, pe=pe, index=False,
                                  **kw)
    for path, ref in zip(fq if pe else (fq,), ref_fq if pe else (ref_fq,)):
        halves = []
        for tag, src in (("snp", path), ("ref", ref)):
            with open(src) as f:
                halves += [f"@{tag}{ln[1:]}" if i % 4 == 0 else ln
                           for i, ln in enumerate(f)]
        with open(path, "w") as g:
            g.writelines(halves)
    return fa, fq, idx


def damage_mates(fq2, every=3, step=9):
    """Rewrite mate-2 FASTQ `fq2`: in every `every`-th record (0, every,
    2*every, ...) each `step`-th base (0, step, ...) moves one letter on in
    ACGT (N becomes C). No exact 19-mer survives, so the mate has no seed,
    while Smith-Waterman near its mate still aligns it: the case mate rescue
    exists for."""
    nxt = {"A": "C", "C": "G", "G": "T", "T": "A", "N": "C"}
    with open(fq2) as f:
        lines = f.read().splitlines()
    for r in range(0, len(lines) // 4, every):
        seq = list(lines[4 * r + 1])
        seq[::step] = [nxt[c] for c in seq[::step]]
        lines[4 * r + 1] = "".join(seq)
    with open(fq2, "w") as f:
        f.write("\n".join(lines) + "\n")


def trim_fastq(path, n_bases):
    """Rewrite FASTQ `path` with every read cut to its first n_bases."""
    with open(path) as f:
        lines = f.read().splitlines()
    for i in range(1, len(lines), 2):  # the sequence and the quality lines
        lines[i] = lines[i][:n_bases]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def add_indels(fq, every, seed):
    """Rewrite FASTQ `fq`: read i with i % every == every // 2 loses 1-3
    bases, read i with i % every == 0 (i > 0) gains 1-2, at a position at
    least 20 bases from either end."""
    import numpy as np
    rng = np.random.default_rng(seed)
    with open(fq) as f:
        lines = f.read().splitlines()
    for r in range(len(lines) // 4):
        seq, qual = lines[4 * r + 1], lines[4 * r + 3]
        if r % every not in (0, every // 2) or r == 0 or len(seq) < 60:
            continue
        p = int(rng.integers(20, len(seq) - 20))
        if r % every == every // 2:
            n = int(rng.integers(1, 4))
            seq, qual = seq[:p] + seq[p + n:], qual[:p] + qual[p + n:]
        else:
            ins = "".join("ACGT"[int(x)] for x in rng.integers(0, 4, int(rng.integers(1, 3))))
            seq, qual = seq[:p] + ins + seq[p:], qual[:p] + "I" * len(ins) + qual[p:]
        lines[4 * r + 1], lines[4 * r + 3] = seq, qual
    with open(fq, "w") as f:
        f.write("\n".join(lines) + "\n")


def _fastq(jax_pkg):
    if jax_pkg:
        from biscuit_tpu.io import fastq
    else:
        from biscuit_tpu_torch.io import fastq
    return fastq


def load_reads(path, n, jax_pkg=False):
    """The first n reads as the port's BSeq (the JAX package's with
    jax_pkg=True)."""
    fastq = _fastq(jax_pkg)
    return fastq.read_batch(fastq.fastq_iter(str(path)), None, 1 << 60)[:n]


def load_pairs(fq1, fq2, jax_pkg=False):
    """Every pair of the two FASTQs, mates interleaved, as the CLI reads
    them."""
    fastq = _fastq(jax_pkg)
    return fastq.read_batch(fastq.fastq_iter(str(fq1)),
                            fastq.fastq_iter(str(fq2)), 1 << 60)


def port_opt(flag=0, **fields):
    """The port's MemOpt with `flag` or-ed in and `fields` set: options of
    the port's own class, for the port's functions only."""
    from biscuit_tpu_torch.config import MemOpt
    return _opt_of(MemOpt, flag, fields)


def jax_opt(flag=0, **fields):
    """The JAX package's MemOpt with the same settings, for its functions
    only: no test hands one options object to both packages."""
    from biscuit_tpu.config import MemOpt
    return _opt_of(MemOpt, flag, fields)


def _opt_of(cls, flag, fields):
    opt = cls()
    opt.flag |= flag
    for k, v in fields.items():
        setattr(opt, k, v)
    return opt


_STRAND_FIELDS = ("words", "occ_cp", "L2", "primary", "seq_len", "sa_samples",
                  "sa_intv")


def index_fields(idx):
    """The fields of either package's BisIndex as numpy arrays, Python
    values and dicts: the arguments of bisindex_from_numpy."""
    strand = lambda s: {f: getattr(s, f) for f in _STRAND_FIELDS}
    return dict(par=strand(idx.par), dau=strand(idx.dau), pac=idx.pac,
                anns=[dict(vars(a)) for a in idx.anns],
                ambs=[dict(vars(a)) for a in idx.ambs], l_pac=idx.l_pac)


def port_index(jax_idx):
    """The port's BisIndex over the arrays of the JAX package's."""
    from biscuit_tpu_torch.index.fmindex import bisindex_from_numpy
    return bisindex_from_numpy(**index_fields(jax_idx))


def jax_index(port_idx):
    """The JAX package's BisIndex over the arrays of the port's."""
    from biscuit_tpu.index.fasta import Amb, Ann
    from biscuit_tpu.index.fmindex import BisIndex, StrandIndex
    f = index_fields(port_idx)
    return BisIndex(par=StrandIndex(**f["par"]), dau=StrandIndex(**f["dau"]),
                    pac=f["pac"], anns=[Ann(**a) for a in f["anns"]],
                    ambs=[Amb(**a) for a in f["ambs"]], l_pac=f["l_pac"])


# ---------------------------------------------------------------------------
# Lanes for the seeder (K3): reads as nt4 code arrays, each converted both ways
# as the engine plans SE lanes
# ---------------------------------------------------------------------------

def lanes_both_ways(reads):
    """Each read (nt4 codes) bisulfite-converted for either strand (C>T for
    the parent strand, G>A for the daughter), padded with 4:
    (q [2n, L] int32, lens [2n] int32, parents [2n] int32) as numpy."""
    import numpy as np
    conv, par = [], []
    for s in reads:
        for p in (0, 1):
            c = np.asarray(s).copy()
            if p:
                c[c == 1] = 3
            else:
                c[c == 2] = 0
            conv.append(c)
            par.append(p)
    L = max([len(s) for s in conv] + [1])
    q = np.full((len(conv), L), 4, np.int32)
    lens = np.zeros(len(conv), np.int32)
    for i, s in enumerate(conv):
        q[i, :len(s)] = s
        lens[i] = len(s)
    return q, lens, np.asarray(par, np.int32)


def seed_edge_reads(reads, seed=9):
    """Reads that aim at what a warp-per-lane seeder can get wrong, made from
    at least six genuine reads (nt4 code arrays) of one genome: a few N
    inside a read, a read shorter than a seed, all N, random bases, an N
    every 7 and every 25 bases, N as the first and as the last base, reads
    of one base and of none, a homopolymer, a dinucleotide and a 7-mer
    tandem repeat of the read's length (long lists of equal intervals), a
    read whose second half is random, two reads joined, and the reverse
    complement of a read."""
    import numpy as np
    rng = np.random.default_rng(seed)
    r = [np.asarray(x).astype(np.int64) for x in reads[:6]]
    L = len(r[0])
    amb = r[0].copy()
    amb[[10, 11, L // 3]] = 4
    every7, every25 = r[1].copy(), r[2].copy()
    every7[::7] = 4
    every25[::25] = 4
    first_n, last_n = r[3].copy(), r[3].copy()
    first_n[0], last_n[-1] = 4, 4
    half = r[4].copy()
    half[L // 2:] = rng.integers(0, 4, L - L // 2)
    return [amb, r[1][:15], np.full(80, 4), rng.integers(0, 4, L), every7,
            every25, first_n, last_n, r[2][:1], r[2][:0],
            np.full(L, int(r[0][0])), np.resize(r[1][:2], L),
            np.resize(r[5][20:27], L), half,
            np.concatenate([r[4][:L // 2], r[5][:L - L // 2]]),
            np.where(r[5] > 3, 4, 3 - r[5])[::-1]]


# ---------------------------------------------------------------------------
# Lanes for the three DP kernels (K1 sw_extend, K7 sw_local, K2 sw_global) that
# aim at what a warp-per-lane kernel with the row in strips of C columns a thread can get
# wrong. The CPU tests put them through the plain versions and the JAX
# functions, the bring-up check on the card through the kernels and the plain
# versions: the same lanes on both sides.
# ---------------------------------------------------------------------------

# (B, Lq, Lt): every strip width the kernels are compiled for (32 * C >= Lq
# with C in 2, 4, 5, 6, 8, 12, 16) and batch sizes around a warp and a block
DP_EDGE_SHAPES = ((1, 16, 40), (31, 40, 64), (33, 100, 120), (130, 150, 300),
                  (37, 160, 200), (9, 176, 190), (6, 250, 260), (5, 300, 310),
                  (3, 500, 510))
# the shapes the CPU tests run (each costs a JAX compilation): C = 2, 4, 5, 8
DP_EDGE_SHAPES_CPU = ((1, 16, 40), (31, 40, 64), (33, 100, 120),
                      (37, 160, 200), (6, 250, 260))


def _planted(rng, q, n_t, kind):
    """A target of n_t bases for query q: kind 0 a copy, 1 a copy that lost
    1-6 bases at a third of its length (the query then needs an insertion
    gap, the F recurrence, often across a strip's edge), 2 a copy that gained
    some (E), 3 a copy of the first third only."""
    import numpy as np
    L = len(q)
    t = rng.integers(0, 4, n_t)
    if kind == 0:
        src = q
    elif kind == 1:
        g = int(rng.integers(1, 7))
        src = np.concatenate([q[:L // 3], q[L // 3 + g:]])
    elif kind == 2:
        g = int(rng.integers(1, 5))
        src = np.concatenate([q[:L // 2], rng.integers(0, 4, g), q[L // 2:]])
    else:
        src = q[:L // 3]
    n = min(len(src), n_t)
    t[:n] = src[:n]
    return t


def _low_complexity(rng, n, period):
    """n bases of a repeat of `period` letters: rows full of equal scores,
    so ties for the row maximum fall on neighbouring columns and strips."""
    import numpy as np
    unit = rng.integers(0, 4, period)
    return np.resize(unit, n)


def extend_edge_case(seed, B, Lq, Lt, w_val=100):
    """K1 lanes, by lane number modulo 8: 0 a full match with qlen = Lq (the
    gscore at the tail) and a target longer than Lt; 1 a homopolymer against
    itself, 2 a dinucleotide repeat (ties); 3 a target that lost bases (F
    across strips); 4 one that gained bases (E); 5 random (dies in the first
    rows); 6 a match of the first third, then garbage; 7 a query of 1-3
    bases. Then single lanes: an empty query (the band is collapsed on the
    first row), an empty target, w = 0, a large h0 (the first row's decay
    and h1_first live long). Some N (code 4) everywhere. Returns the numpy
    inputs of sw_extend_batch without the scores:
    (query, qlens, target, tlens, mats, matsel, w, bonus, h0)."""
    import numpy as np
    from biscuit_tpu_torch.config import MemOpt
    opt = MemOpt()
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (B, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (B, Lt)).astype(np.int32)
    qlens = rng.integers(max(Lq // 2, 1), Lq + 1, B).astype(np.int32)
    tlens = rng.integers(max(Lt // 2, 1), Lt + 1, B).astype(np.int32)
    h0 = rng.integers(1, 60, B).astype(np.int32)
    for b in range(B):
        k = b % 8
        if k == 0:
            qlens[b], tlens[b] = Lq, Lt + 7
            t[b] = _planted(rng, q[b], Lt, 0)
        elif k in (1, 2):
            q[b] = _low_complexity(rng, Lq, k)
            t[b] = np.resize(q[b], Lt)
        elif k in (3, 4):
            t[b] = _planted(rng, q[b, :qlens[b]], Lt, k - 2)
        elif k == 6:
            t[b] = _planted(rng, q[b, :qlens[b]], Lt, 3)
        elif k == 7:
            qlens[b] = rng.integers(1, 4)
            t[b, :qlens[b]] = q[b, :qlens[b]]
    q[rng.random((B, Lq)) < 0.01] = 4
    t[rng.random((B, Lt)) < 0.01] = 4
    w = np.full(B, w_val, np.int32)
    for b, what in ((8, "q0"), (11, "t0"), (12, "w0"), (16, "h0")):
        if b < B:
            if what == "q0":
                qlens[b] = 0
            elif what == "t0":
                tlens[b] = 0
            elif what == "w0":
                w[b] = 0
            else:
                h0[b] = 200
    bonus = np.where(rng.random(B) < 0.5, opt.pen_clip5, 0)
    msel = rng.integers(0, 2, B)
    mats = np.stack([opt.gamat, opt.ctmat])
    return tuple(a.astype(np.int32) for a in
                 (q, qlens, t, tlens, mats, msel, w, bonus, h0))


def global_edge_case(seed, B, Lq, Lt, w_val=100):
    """K2 lanes, by lane number modulo 8: 0 a full match with qlen = Lq and
    a target longer than Lt (the DP stops at row Lt); 1 a homopolymer against
    itself, 2 a dinucleotide repeat (ties between M, E and F); 3 a target
    that lost bases (F, often across a strip's edge); 4 one that gained
    bases (E); 5 random (sentinel cells reach the band); 6 a match of the
    first third, then garbage; 7 a query of 1-3 bases. Then single lanes: an
    empty query, tlen = 1, tlen = 0 and w = 0 (both clamped to 1 by the DP),
    qlen = Lq under w = 1. Some N (code 4) everywhere; three matrices (the
    two bisulfite ones and match 1 / mismatch -2). Returns the numpy inputs
    of sw_global_batch without the scores:
    (query, qlens, target, tlens, mats, matsel, w). A traceback is asked
    only of tlens clamped to Lt."""
    import numpy as np
    from biscuit_tpu_torch.config import MemOpt
    opt = MemOpt()
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (B, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (B, Lt)).astype(np.int32)
    qlens = rng.integers(max(Lq // 2, 1), Lq + 1, B).astype(np.int32)
    tlens = rng.integers(max(Lt // 2, 1), Lt + 1, B).astype(np.int32)
    for b in range(B):
        k = b % 8
        if k == 0:
            qlens[b], tlens[b] = Lq, Lt + 7
            t[b] = _planted(rng, q[b], Lt, 0)
        elif k in (1, 2):
            q[b] = _low_complexity(rng, Lq, k)
            t[b] = np.resize(q[b], Lt)
        elif k in (3, 4):
            t[b] = _planted(rng, q[b, :qlens[b]], Lt, k - 2)
        elif k == 6:
            t[b] = _planted(rng, q[b, :qlens[b]], Lt, 3)
        elif k == 7:
            qlens[b] = rng.integers(1, 4)
            t[b, :qlens[b]] = q[b, :qlens[b]]
    q[rng.random((B, Lq)) < 0.01] = 4
    t[rng.random((B, Lt)) < 0.01] = 4
    w = np.full(B, w_val, np.int32)
    for b, what in ((9, "q0"), (10, "t1"), (11, "t0"), (12, "w0"), (13, "w1")):
        if b < B:
            if what == "q0":
                qlens[b] = 0
            elif what == "t1":
                tlens[b] = 1
            elif what == "t0":
                tlens[b] = 0
            elif what == "w0":
                w[b] = 0
            else:
                qlens[b], w[b] = Lq, 1
    plain = np.where(np.eye(5, dtype=bool), 1, -2)
    plain[4, :] = plain[:, 4] = -1
    mats = np.stack([opt.gamat, opt.ctmat, plain])
    msel = rng.integers(0, 3, B)
    return tuple(a.astype(np.int32) for a in (q, qlens, t, tlens, mats, msel, w))


def local_edge_case(seed, B, Lq, Lt, a=1, b_pen=2):
    """K7 lanes (Lq a multiple of 16), by lane number modulo 6: 0 a copy of
    the query in the target; 1 a homopolymer, 2 a dinucleotide repeat (ties
    for the row maximum and for qe across strips); 3 a target that lost
    bases (F across strips); 4 random; 5 repeats of the query (u8 lanes
    saturate at a = 4). qlens straddle the stripes: 16 k, 16 k + 1, 8 k + 1,
    so that `ext` and the pad columns cut through strips; single lanes with
    an empty query, an empty target, qlen = Lq, qlen = 1; u8 and i16 mixed;
    a third of the lanes stop on a small endsc. Matrices as
    tests/test_sw_local.py makes them, match a, mismatch -b_pen. Returns
    (query, qlens, target, tlens, mats, matsel), (minsc, endsc, u8)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    q = np.full((B, Lq), 4, np.int32)
    t = np.full((B, Lt), 4, np.int32)
    qlens = rng.integers(1, Lq + 1, B).astype(np.int32)
    tlens = rng.integers(max(Lt // 2, 1), Lt + 1, B).astype(np.int32)
    for b in range(B):
        r = b % 4
        if r == 0:
            qlens[b] = min(Lq, max(16, qlens[b] // 16 * 16))
        elif r == 1:
            qlens[b] = min(Lq, qlens[b] // 16 * 16 + 1)
        elif r == 2:
            qlens[b] = min(Lq, qlens[b] // 8 * 8 + 1)
    for b, n in ((4, 0), (7, Lq), (10, 1)):
        if b < B:
            qlens[b] = n
    if 9 < B:
        tlens[9] = 0
    for b in range(B):
        ql, tl = int(qlens[b]), int(tlens[b])
        k = b % 6
        qq = _low_complexity(rng, ql, k) if k in (1, 2) else \
            rng.integers(0, 4, ql)
        tt = rng.integers(0, 4, tl)
        if ql and tl:
            off = int(rng.integers(0, max(1, tl - ql)))
            if k in (0, 1, 2):
                src = np.resize(qq, tl - off) if k else qq
            elif k == 3:
                src = _planted(rng, qq, max(ql - 8, 1), 1)
            elif k == 5:
                src = np.resize(qq, tl - off)
            else:
                src = tt[:0]
            n = min(len(src), tl - off)
            tt[off:off + n] = src[:n]
            nm = int(rng.integers(0, 1 + tl // 16))
            tt[rng.integers(0, tl, nm)] = rng.integers(0, 4, nm)
        q[b, :ql] = qq
        t[b, :tl] = tt
    m = np.zeros((2, 5, 5), np.int32)
    m[:, :4, :4] = -b_pen
    for i in range(4):
        m[:, i, i] = a
    m[1] = m[0].T
    m[1, 0, 1] = a
    matsel = rng.integers(0, 2, B).astype(np.int32)
    u8 = rng.integers(0, 2, B).astype(np.int32)
    minsc = rng.integers(10, 60, B).astype(np.int32)
    endsc = np.where(rng.random(B) < 0.33, rng.integers(5, 80, B),
                     0x10000).astype(np.int32)
    return (q, qlens, t, tlens, m, matsel), (minsc, endsc, u8)


# ---------------------------------------------------------------------------
# the pileup window count (K9): a window's data as the engine makes them
# ---------------------------------------------------------------------------

# kinds of window: reads in coordinate order (one sample, two samples one
# after the other), the same data shuffled (no chunk of the kernel stays
# narrow), every datum on one site, no data, and passing codes in [21, 32)
WINDOW_KINDS = ("sorted", "two_samples", "shuffled", "one_site", "empty",
                "code_21_to_31")


def window_count_case(kind, seed=0, P=700, n=4000, read_len=150):
    """A window's data as the pileup engine hands them to _device_counts:
    (p, sid, stat, passm, P, n_bams) as numpy, p the window-relative site
    (int64), sid the sample, stat base << 4 | meth (base in [0, 7), meth in
    [0, 3); for kind code_21_to_31 a twentieth of the data hold codes
    base * 3 + meth in [21, 32)), passm the datum filter (nine in ten
    pass). Reads of read_len bases (shorter where P is small) cover
    consecutive sites from sorted starts, each sample's reads in order."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n_bams = 2 if kind == "two_samples" else 1
    n = 0 if kind == "empty" else n
    ln = max(1, min(read_len, P // 4))
    n_reads = -(-n // ln)
    sid = np.sort(rng.integers(0, n_bams, n_reads))
    start = rng.integers(0, P - ln + 1, n_reads)
    order = np.lexsort((start, sid))  # sample by sample, each in order
    p = (start[order][:, None] + np.arange(ln)[None, :]).reshape(-1)[:n]
    sid = np.repeat(sid[order], ln)[:n].astype(np.int64)
    if kind == "one_site":
        p[:] = P // 3
    code = rng.integers(0, 7, n) * 3 + rng.integers(0, 3, n)
    if kind == "code_21_to_31":
        odd = rng.random(n) < 0.05
        code[odd] = rng.integers(21, 32, int(odd.sum()))
    stat = (code // 3) << 4 | code % 3
    passm = rng.random(n) >= 0.1
    if kind == "shuffled":
        perm = rng.permutation(n)
        p, sid, stat, passm = p[perm], sid[perm], stat[perm], passm[perm]
    return p.astype(np.int64), sid, stat.astype(np.int64), passm, P, n_bams


def window_count_inputs(p, sid, stat, passm, P, n_bams):
    """The fused count's inputs for those data, as the engine stages them:
    (int32 sites site * n_bams + sample, uint8 codes base * 3 + meth, bool
    pass) as numpy, and the window P * n_bams."""
    import numpy as np
    return ((p * n_bams + sid).astype(np.int32),
            ((stat >> 4) * 3 + (stat & 0xF)).astype(np.uint8),
            np.asarray(passm, bool)), P * n_bams


# ---------------------------------------------------------------------------
# the chain scan (K6): occurrence streams at the scan's edges
# ---------------------------------------------------------------------------

def chain_edge_lanes(NC, l_pac, seed=0, jmax=1024):
    """Occurrence streams of four lanes, each a list of records (qbeg, len,
    rbeg, valid, rid, k) as mem_chain_batch visits them, with rbeg on both
    sides of l_pac: a lane of jmax occurrences (a long read's seeds in
    order, each with one to four occurrences on six loci 2000 apart, one
    locus growing across l_pac; one seed in twenty repeated, which the
    scan finds contained; one occurrence in twenty invalid); lanes of
    exactly NC and of NC + 1 chains (one occurrence each, 500 apart, in a
    shuffled order, so that inserts land everywhere); and a lane whose
    second seed would append to a chain below l_pac from above it (pacrej),
    then one that appends above."""
    import numpy as np
    rng = np.random.default_rng(seed)
    loci = l_pac - 600 + 2000 * np.arange(-3, 3)
    long_lane, qb, last = [], 0, []
    while len(long_lane) < jmax:
        if last and rng.random() < 0.05:
            long_lane += last
            continue
        ln = int(rng.integers(19, 40))
        last = [(qb, ln, int(loci[i]) + qb + int(rng.integers(0, 2)),
                 int(rng.random() >= 0.05), 0, k)
                for k, i in enumerate(rng.permutation(6)[:rng.integers(1, 5)])]
        long_lane += last
        qb += int(rng.integers(1, 4))
    lanes = [long_lane[:jmax]]
    for m in (NC, NC + 1):
        lanes.append([(10, 20, l_pac - 250 * m + 500 * int(i), 1, 0, 0)
                      for i in rng.permutation(m)])
    lanes.append([(0, 20, l_pac - 30, 1, 0, 0), (35, 20, l_pac + 5, 1, 0, 0),
                  (70, 20, l_pac + 40, 1, 0, 0)])
    return lanes


def chain_planes(lanes, rdt):
    """The scan's inputs for lanes of records: six [J, B] planes (rbeg of
    dtype rdt, the others int32) and n_occ [B], as numpy."""
    import numpy as np
    J, B = max([len(r) for r in lanes] + [1]), len(lanes)
    planes = [np.zeros((J, B), np.int32) for _ in range(6)]
    planes[2] = planes[2].astype(rdt)
    n_occ = np.zeros(B, np.int32)
    for b, recs in enumerate(lanes):
        n_occ[b] = len(recs)
        for j, rec in enumerate(recs):
            for c in range(6):
                planes[c][j, b] = rec[c]
    return planes, n_occ


# ---------------------------------------------------------------------------
# K4, the SA walk: seed-interval rows in the layout of its interval entry
# ---------------------------------------------------------------------------

SA_ROW_CASES = ("random", "edge", "empty", "one_row_64", "sampled")


def sa_intv_view(fm, sa_intv):
    """The same FM tables with the SA samples stride-subsampled to every
    sa_intv-th rank (sa_intv a multiple of fm's): no index build, and the
    walks of an index sampled that sparsely (the reference format's 32)."""
    from biscuit_tpu_torch.ops.seed_batch import FMPair
    step = sa_intv // fm.sa_intv
    return FMPair.from_numpy(
        fm.tab.cpu().numpy().view("uint32"), fm.L2.cpu().numpy(),
        fm.primary.cpu().numpy(), fm.seq_len,
        fm.sa_samples.cpu().numpy()[:, ::step], fm.wide, sa_intv,
        fm.tab.device)


def sa_rows(case, seq_len, primary, sa_intv, cap=64, n=300, seed=0):
    """Rows (which, x0, kmax) of one case as int64 numpy arrays, every
    rank in [0, seq_len]: "random" (n rows, kmax mostly 1, some up to
    cap, a few 0), "edge" (kmax 0; cap ranks of a seed with more
    occurrences; rows that start at, end at and run across either strand's
    primary row; the last rank seq_len; rank 0, whose sample is the -1
    sentinel; ranks already sampled, 0 steps), "empty", "one_row_64" (one
    row of 64 ranks) and "sampled" (n rows of one sampled rank)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    rows = []
    if case == "random":
        kmax = rng.choice([0, 1, 1, 1, 1, 1, 2, 3, 7, cap], n)
        for w, k in zip(rng.integers(0, 2, n), kmax):
            rows.append((w, int(rng.integers(0, seq_len + 2 - k)), k))
    elif case == "edge":
        for w in (0, 1):
            p = int(primary[w])
            rows += [(w, 5, 0), (w, p, 3), (w, p - 2, 3), (w, p - 1, 1),
                     (w, seq_len, 1), (w, seq_len - 2, 3), (w, 0, 1),
                     (w, 0, 2), (w, sa_intv, 1),
                     (w, int(rng.integers(0, seq_len - cap)), cap),
                     (w, 7 * sa_intv, 0), (w, 3 * sa_intv, sa_intv + 1)]
    elif case == "one_row_64":
        rows.append((1, int(rng.integers(0, seq_len - 64)), 64))
    elif case == "sampled":
        for w in rng.integers(0, 2, n):
            rows.append((w, sa_intv * int(rng.integers(0, seq_len // sa_intv)),
                         1))
    elif case != "empty":
        raise ValueError(case)
    which, x0, kmax = (np.asarray([r[c] for r in rows], np.int64)
                       for c in range(3))
    return which, x0, kmax


def sa_rows_expanded(which, x0, kmax):
    """Each row's ranks, as the per-occurrence packing expands them:
    (strand, rank) of every job in row order, int64 numpy."""
    import numpy as np
    within = np.arange(int(kmax.sum())) - np.repeat(np.cumsum(kmax) - kmax,
                                                    kmax)
    return np.repeat(which, kmax), np.repeat(x0, kmax) + within


def repeat_dataset(d, unit_len=150, copies=80, flank=20000, n_reads=40,
                   read_len=100, seed=4):
    """A genome of one chromosome, random flanks around `copies` exact
    copies of a random unit, and directional reads (every C read as T)
    drawn half from the repeat and half from the flanks: seeds of the
    repeat have about `copies` occurrences, more than SA_PREFETCH_CAP.
    Writes genome.fa (indexed) and reads.fq into d; returns (fasta, reads,
    the port's BisIndex)."""
    import numpy as np
    from biscuit_tpu_torch.index.build import build_index
    rng = np.random.default_rng(seed)
    acgt = np.array(list("ACGT"))
    unit = "".join(acgt[rng.integers(0, 4, unit_len)])
    left, right = ("".join(acgt[rng.integers(0, 4, flank)]) for _ in "lr")
    genome = left + unit * copies + right
    os.makedirs(str(d), exist_ok=True)
    fa, fq = os.path.join(str(d), "genome.fa"), os.path.join(str(d), "reads.fq")
    with open(fa, "w") as f:
        f.write(">chrR\n")
        for i in range(0, len(genome), 60):
            f.write(genome[i:i + 60] + "\n")
    with open(fq, "w") as f:
        for i in range(n_reads):
            lo, hi = ((flank, flank + unit_len * copies - read_len) if i % 2
                      else (0, flank - read_len))
            b = int(rng.integers(lo, hi))
            read = genome[b:b + read_len].replace("C", "T")
            f.write(f"@r{i}\n{read}\n+\n{'I' * read_len}\n")
    return fa, fq, build_index(fa, prefix=fa)


def allgather_rank(rank, n, out_dir):
    """One of n gloo ranks (a file store in out_dir) that pools lists of
    unequal length, rank r's range(10 r, 10 r + 3 + r), through
    TorchProcessAllgather and through the exchange's from_env under
    BISCUIT_TPU_TORCH_PES_EXCHANGE=torch, then [0, 1] from rank 1 alone,
    then nothing from every rank; writes the four results to
    out_dir/rank<r>.txt, a line each."""
    import torch.distributed as dist

    from biscuit_tpu_torch.parallel import exchange
    dist.init_process_group("gloo", rank=rank, world_size=n,
                            init_method="file://" + os.path.join(out_dir,
                                                                 "store"))
    mine = list(range(rank * 10, rank * 10 + 3 + rank))
    got = [exchange.TorchProcessAllgather()(mine)]
    os.environ["BISCUIT_TPU_TORCH_PES_EXCHANGE"] = "torch"
    got.append(exchange.from_env()(mine))
    got.append(exchange.TorchProcessAllgather()([0, 1] if rank == 1 else []))
    got.append(exchange.TorchProcessAllgather()([]))
    with open(os.path.join(out_dir, f"rank{rank}.txt"), "w") as f:
        f.write("\n".join(" ".join(map(str, g)) for g in got))
    dist.destroy_process_group()
