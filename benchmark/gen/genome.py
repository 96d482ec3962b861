"""A deployment's reference genome and sample, made from the config's seed.

Provenance: a frozen, vectorised form of tools/make_testdata.py's pattern (a
random genome drawn base by base from a seeded numpy generator, SNPs drawn
into a sample), with what a human-like deployment adds: GC 41% with CpG
depleted outside islands, CpG islands at the human density, Alu-like and
L1-like repeat families planted at the human genome's shares (Lander et al.,
Nature 2001) with every copy diverged from its family's consensus, and a
diploid sample at human heterozygosity.

Bases are codes 0..3 (A, C, G, T). The genome is one concatenated array cut
into `chroms` equal chromosomes; `starts` are their offsets.
"""
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np

ASCII = np.frombuffer(b"ACGTN", np.uint8)
GENOME_KEYS = ("genome_seed", "genome_bp", "chroms", "gc", "cpg_oe",
               "island_every_bp", "island_len", "island_gc", "alu_len",
               "alu_share", "l1_len", "l1_min_len", "l1_share",
               "repeat_div", "snp_het", "snp_hom", "indel_het", "indel_hom",
               "indel_max", "meth_cpg", "meth_island", "wide_index")


@dataclass
class Genome:
    codes: np.ndarray      # uint8 [n], the reference
    names: list
    starts: np.ndarray     # int64 [chroms + 1]
    haps: list             # two uint8 arrays, the sample's haplotypes
    keys: list             # two int32 arrays: each haplotype base's
                           # reference coordinate, or its predecessor's
                           # where it is inserted
    beta: np.ndarray       # float32 [n], methylation level of a CpG's C and G
    fasta: str             # path of the reference FASTA (the index beside it)

    def chrom_of(self, pos: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.starts, pos, side="right") - 1


def genome_key(cfg: dict) -> str:
    """The cache key of a config's genome: a hash of the keys that make it,
    so that deployments with the same genome share one index."""
    sub = {k: cfg[k] for k in GENOME_KEYS}
    return hashlib.sha256(json.dumps(sub, sort_keys=True).encode()
                          ).hexdigest()[:16]


def _draw(rng, n: int, gc: float) -> np.ndarray:
    at = (1.0 - gc) / 2
    return np.searchsorted(np.cumsum([at, gc / 2, gc / 2]),
                           rng.random(n, dtype=np.float32)).astype(np.uint8)


def _copies(rng, consensus: np.ndarray, lens: np.ndarray, div) -> np.ndarray:
    """Copies of a family, the 3' `lens[i]` bases of its consensus (5'
    truncation), each diverged by substitutions at its own rate in `div`
    and half of them reverse-complemented; concatenated."""
    k, total = len(lens), int(lens.sum())
    first = np.cumsum(lens) - lens
    local = np.arange(total) - np.repeat(first, lens)
    rev = np.repeat(rng.random(k) < 0.5, lens)
    off = np.repeat(len(consensus) - lens, lens)
    ln = np.repeat(lens, lens)
    seq = consensus[off + np.where(rev, ln - 1 - local, local)]
    seq = np.where(rev, 3 - seq, seq).astype(np.uint8)
    rate = np.repeat(rng.uniform(div[0], div[1], k).astype(np.float32), lens)
    hit = rng.random(total, dtype=np.float32) < rate
    seq[hit] = (seq[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    return seq


def make_reference(cfg: dict):
    """(codes, islands) of the config's reference genome."""
    rng = np.random.default_rng(cfg["genome_seed"])
    n = int(cfg["genome_bp"])
    # elements: Alu-like copies, L1-like copies (5'-truncated), islands
    n_alu = int(cfg["alu_share"] * n / cfg["alu_len"])
    alu = _copies(rng, _draw(rng, cfg["alu_len"], 0.52),
                  np.full(n_alu, cfg["alu_len"]), cfg["repeat_div"])
    l1_lens = rng.integers(cfg["l1_min_len"], cfg["l1_len"] + 1,
                           int(2 * cfg["l1_share"] * n
                               / (cfg["l1_len"] + cfg["l1_min_len"])))
    l1 = _copies(rng, _draw(rng, cfg["l1_len"], 0.42), l1_lens,
                 cfg["repeat_div"])
    n_isl = max(1, n // cfg["island_every_bp"])
    isl_lens = rng.integers(cfg["island_len"][0], cfg["island_len"][1] + 1,
                            n_isl)
    isl = _draw(rng, int(isl_lens.sum()), cfg["island_gc"])
    lens = np.concatenate([np.full(n_alu, cfg["alu_len"]), l1_lens, isl_lens])
    kind = np.concatenate([np.zeros(n_alu + len(l1_lens), bool),
                           np.ones(n_isl, bool)])
    pieces = np.concatenate([alu, l1, isl])
    first = np.cumsum(lens) - lens
    n_bg = n - int(lens.sum())
    if n_bg < 0:
        raise ValueError("the genome's elements exceed its size")
    bg = _draw(rng, n_bg, cfg["gc"])
    # elements in a random order between background runs of random lengths
    order = rng.permutation(len(lens))
    cuts = np.sort(rng.integers(0, n_bg + 1, len(lens)))
    gaps = np.diff(np.concatenate([[0], cuts, [n_bg]]))
    out_lens = np.empty(2 * len(lens) + 1, np.int64)
    out_lens[0::2] = gaps
    out_lens[1::2] = lens[order]
    out_first = np.cumsum(out_lens) - out_lens
    # source of every output base: background run or element, vectorised
    src_first = np.empty_like(out_first)
    src_first[0::2] = np.cumsum(gaps) - gaps
    src_first[1::2] = first[order] + n_bg
    local = np.arange(n) - np.repeat(out_first, out_lens)
    codes = np.concatenate([bg, pieces])[np.repeat(src_first, out_lens)
                                         + local]
    isl_at = out_first[1::2][kind[order]]
    isl_ln = lens[order][kind[order]]
    islands = np.stack([isl_at, isl_at + isl_ln], 1)
    islands = islands[np.argsort(islands[:, 0])]
    # outside the islands, CpG depleted to the observed/expected ratio
    # cpg_oe, as methylated CpGs decay by deamination
    codes = codes.astype(np.uint8)
    cg = np.nonzero((codes[:-1] == 1) & (codes[1:] == 2))[0]
    cg = cg[~_in_intervals(islands, cg)]
    cg = cg[rng.random(len(cg), dtype=np.float32) >= cfg["cpg_oe"]]
    half = rng.random(len(cg)) < 0.5
    codes[cg[half]] = 3          # C>T
    codes[cg[~half] + 1] = 0     # G>A (a C>T on the other strand)
    return codes, islands


def make_sample(cfg: dict, codes: np.ndarray, islands: np.ndarray):
    """(haps, keys, beta): the diploid sample's two haplotypes, SNPs at the
    config's heterozygous and homozygous rates and indels (1-`indel_max`
    bases, geometric, half insertions) at theirs; for each haplotype base
    the reference coordinate at or before it (`keys`: an inserted base
    repeats its predecessor's); and each reference CpG's methylation level,
    set on its C and its G, lower inside islands."""
    rng = np.random.default_rng(cfg["genome_seed"] + 1)
    n = len(codes)
    snp = np.stack([codes, codes])
    haps, keys = [], []
    # events: SNPs and indels, each on one haplotype (het) or both (hom)
    events = {}
    for kind in ("snp", "indel"):
        r = rng.random(n, dtype=np.float32)
        het = np.nonzero(r < cfg[kind + "_het"])[0]
        hom = np.nonzero((r >= cfg[kind + "_het"]) & (
            r < cfg[kind + "_het"] + cfg[kind + "_hom"]))[0]
        which = np.concatenate([rng.integers(0, 2, len(het)),
                                np.full(len(hom), 2)])
        events[kind] = (np.concatenate([het, hom]), which)
    pos, which = events["snp"]
    alt = ((codes[pos] + rng.integers(1, 4, len(pos))) % 4).astype(np.uint8)
    for h in (0, 1):
        on = (which == h) | (which == 2)
        snp[h, pos[on]] = alt[on]
    pos, which = events["indel"]
    ln = np.minimum(rng.geometric(0.5, len(pos)), cfg["indel_max"])
    ins = rng.random(len(pos)) < 0.5
    for h in (0, 1):
        on = ((which == h) | (which == 2)) & (pos < n - cfg["indel_max"] - 1)
        keep = np.ones(n, bool)
        for p_, l_ in zip(pos[on & ~ins], ln[on & ~ins]):
            keep[p_ + 1:p_ + 1 + l_] = False
        extra = np.zeros(n, np.int64)
        extra[pos[on & ins]] = ln[on & ins]
        extra[~keep] = 0
        units = np.nonzero(keep)[0]
        reps = 1 + extra[units]
        key = np.repeat(units, reps).astype(np.int32)
        first = np.cumsum(reps) - reps
        inserted = np.ones(len(key), bool)
        inserted[first] = False
        hap = snp[h][key]
        hap[inserted] = rng.integers(0, 4, int(inserted.sum()))
        haps.append(hap)
        keys.append(key)
    beta = np.zeros(n, np.float32)
    cg = np.nonzero((codes[:-1] == 1) & (codes[1:] == 2))[0]
    inside = _in_intervals(islands, cg)
    mean = np.where(inside, cfg["meth_island"], cfg["meth_cpg"])
    # a site's level: Beta with its region's mean and a concentration of 4
    lv = rng.beta(4 * mean, 4 * (1 - mean)).astype(np.float32)
    beta[cg] = lv
    beta[cg + 1] = lv
    return haps, keys, beta


def _in_intervals(iv: np.ndarray, pos: np.ndarray) -> np.ndarray:
    i = np.searchsorted(iv[:, 0], pos, side="right") - 1
    return (i >= 0) & (pos < iv[np.maximum(i, 0), 1])


def write_fasta(path: str, names, starts, codes: np.ndarray,
                width: int = 70) -> None:
    with open(path, "wb") as f:
        for i, name in enumerate(names):
            seq = ASCII[codes[starts[i]:starts[i + 1]]]
            n_full = len(seq) // width
            body = np.empty((n_full, width + 1), np.uint8)
            body[:, :width] = seq[:n_full * width].reshape(n_full, width)
            body[:, width] = 10
            f.write(f">{name}\n".encode())
            f.write(body.tobytes())
            if len(seq) % width:
                f.write(seq[n_full * width:].tobytes() + b"\n")


BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)


def cache_root() -> str:
    """The benchmark's cache directory, at a fixed path in the checkout."""
    return os.path.join(BENCH_DIR, "cache")


def load_genome(cfg: dict, log=print):
    """The config's genome, built with its index on first use into the
    checkout's cache (benchmark/cache/genome-<key>/) and read from there
    after. The index is the port's `index` subcommand's, run in a process of
    its own, with the wide layout forced where the config asks for it.
    Returns (Genome, seconds the index took to build here, 0 if cached)."""
    d = os.path.join(cache_root(), "genome-" + genome_key(cfg))
    fa = os.path.join(d, "genome.fa")
    built = 0.0
    if not os.path.exists(os.path.join(d, "done")):
        if os.path.isdir(d):
            shutil.rmtree(d)  # a build cut short
        os.makedirs(d)
        codes, islands = make_reference(cfg)
        n = len(codes)
        k = int(cfg["chroms"])
        starts = np.array([n * i // k for i in range(k + 1)], np.int64)
        names = [f"chr{i + 1}" for i in range(k)]
        write_fasta(fa, names, starts, codes)
        np.save(os.path.join(d, "codes.npy"), codes)
        haps, keys, beta = make_sample(cfg, codes, islands)
        for h in (0, 1):
            np.save(os.path.join(d, f"hap{h}.npy"), haps[h])
            np.save(os.path.join(d, f"key{h}.npy"), keys[h])
        np.save(os.path.join(d, "beta.npy"), beta)
        del haps, keys, beta
        with open(os.path.join(d, "chroms.json"), "w") as f:
            json.dump({"names": names, "starts": starts.tolist()}, f)
        env = dict(os.environ)
        if cfg["wide_index"]:
            env["BISCUIT_TPU_WIDE_INDEX"] = "1"
        log(f"[benchmark] building the index of {n} bp in {d}")
        t = time.perf_counter()
        subprocess.run([sys.executable, "-m", "biscuit_tpu_torch.cli", "index",
                        fa], check=True, env=env,
                       cwd=REPO)
        built = time.perf_counter() - t
        open(os.path.join(d, "done"), "w").close()
    codes = np.load(os.path.join(d, "codes.npy"))
    with open(os.path.join(d, "chroms.json")) as f:
        ch = json.load(f)
    haps = [np.load(os.path.join(d, f"hap{h}.npy")) for h in (0, 1)]
    keys = [np.load(os.path.join(d, f"key{h}.npy")) for h in (0, 1)]
    beta = np.load(os.path.join(d, "beta.npy"))
    return Genome(codes, ch["names"], np.asarray(ch["starts"], np.int64),
                  haps, keys, beta, fa), built
