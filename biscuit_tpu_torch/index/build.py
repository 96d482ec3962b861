"""Index construction (the `index` subcommand).

Reproduces the reference pipeline (lib/aln/bwtindex.c:206-347)
with a different construction algorithm: instead of is.c / bwt_gen.c we build
a plain suffix array with native SA-IS (biscuit_tpu/native/sais.cpp) and
derive BWT + occ checkpoints + sampled SA from it. The resulting values are
identical to the reference's bwt_t (tested against oracle-built .bwt/.sa
files); only the on-disk layout is new (gather-friendly npz, fmindex.py).

Converted-genome semantics (bntseq.c:542-633):
  parent  = [C->T(fwd), C->T(revcomp(fwd))]   (conversion AFTER revcomp)
  daughter= [G->A(fwd), G->A(revcomp(fwd))]
with N bases randomized from the same lrand48(seed=11) stream in each pass.

Copy of biscuit_tpu/index/build.py: the code is the source's, so that the port
imports nothing of the JAX package; tests/test_torch_engine.py holds the
copy to its source.
"""
import numpy as np

from .. import native
from .fasta import pack_genome
from .fmindex import BisIndex, StrandIndex, build_strand_index


_CONV_CHUNK = 64 * 1024 * 1024


def converted_doubled(codes: np.ndarray, parent: bool) -> np.ndarray:
    """Doubled converted sequence for one strand index.

    Assembled chunk-by-chunk into one preallocated buffer so peak transient
    memory stays ~2n+eps bytes (a human 3.1 Gbp genome would otherwise burn
    ~25 GB in concatenate/where temporaries)."""
    n = len(codes)
    out = np.empty(2 * n, dtype=np.uint8)
    src, dst = (1, 3) if parent else (2, 0)  # C->T | G->A
    for lo in range(0, n, _CONV_CHUNK):
        hi = min(lo + _CONV_CHUNK, n)
        c = codes[lo:hi].astype(np.uint8, copy=True)
        c[c == src] = dst
        out[lo:hi] = c
        # reverse complement lands mirrored at the tail: rev[i] = 3 - fwd[n-1-i],
        # so source chunk [lo, hi) maps to [2n-hi, 2n-lo)
        r = (3 - codes[lo:hi][::-1]).astype(np.uint8)
        r[r == src] = dst
        out[2 * n - hi:2 * n - lo] = r
    return out


def _use_bwt_merge(n: int) -> bool:
    """Semi-external blockwise construction (native/bwt_merge.cpp) replaces
    the in-memory SA-IS when the full suffix array would dominate peak
    memory. Default: any strand past the int32-SA limit (where SA-IS would
    need 8 bytes/char ≈ 50 GB at human scale; the reference handles this
    regime with incremental BWT-SW, lib/aln/bwt_gen.c). BISCUIT_TPU_BWT_MERGE
    forces it on (1) or off (0) at any size for testing."""
    import os
    v = os.environ.get("BISCUIT_TPU_BWT_MERGE")
    if v is not None:
        return v == "1"
    return n >= (1 << 31) - 16


def build_strand(codes: np.ndarray, parent: bool) -> StrandIndex:
    doubled = converted_doubled(codes, parent)
    n = len(doubled)
    if _use_bwt_merge(n):
        from .fmindex import (build_strand_index_from_parts, default_sa_intv,
                              index_is_wide)
        intv = default_sa_intv(wide=index_is_wide(n))
        words, occ_cp, primary, sa = native.bwt_merge(doubled, intv)
        del doubled
        return build_strand_index_from_parts(words, occ_cp, primary, n,
                                             sa, intv)
    sa = native.suffix_array(doubled)
    bwt_codes, primary = native.bwt_from_sa(doubled, sa)
    return build_strand_index(doubled, sa, bwt_codes, primary)


def build_index(fasta_path: str, prefix: str | None = None) -> BisIndex:
    pg = pack_genome(fasta_path)
    idx = BisIndex(
        par=build_strand(pg.codes, parent=True),
        dau=build_strand(pg.codes, parent=False),
        pac=pg.codes,
        anns=pg.anns,
        ambs=pg.ambs,
        l_pac=pg.l_pac,
    )
    if prefix:
        idx.save(prefix)
    return idx
