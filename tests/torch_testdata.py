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
