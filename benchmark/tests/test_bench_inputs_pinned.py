"""The inputs and the align options of the cells that were measured before
configurations could state align options, barcoded read names and an RRBS
pileup sample: their FASTQ and BAM bytes and the MemOpt that the align loop
builds, pinned to the digests those cells gave at the tests' small sizes.
A change to the generators or the option table that moves any of them
changes what those cells measure."""
import hashlib

import numpy as np
import pytest

from benchmark import run
from benchmark.gen import bam as bmod
from benchmark.gen import genome as gmod
from benchmark.gen import reads as rmod
from benchmark.tests.conftest import SIZES, bench

# sha256 of the inputs, first 16 hex digits, taken on the commit before
# configurations gained align_options, barcodes and the RRBS pileup sample
INPUTS = {
    ("wgbs-pe150.align", 5): "e03884aee5d28718",
    ("wgbs-pe150.align", 6): "161c75c15028a3de",
    ("rrbs-se100.align", 5): "d490cadd56e21e4e",
    ("rrbs-se100.align", 6): "b9f7c9ba314fc637",
    ("wgbs-pe150.pileup", 5): "ce9df9657260af9b",
    ("wgbs-pe150.pileup", 6): "6ae402cd8acfc4e5",
}
OPTIONS = {
    ("wgbs-pe150.align", False): "7774d55732fd1963",
    ("wgbs-pe150.align", True): "a85fbe1227381d15",
    ("rrbs-se100.align", False): "0792173b2de43b0d",
    ("rrbs-se100.align", True): "7779dd4391f91e92",
}


def _files_digest(paths) -> str:
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _opt_digest(opt) -> str:
    """Every field of a MemOpt and the scoring matrices it derives."""
    h = hashlib.sha256()
    for k in sorted(vars(opt)):
        v = vars(opt)[k]
        h.update(k.encode())
        if isinstance(v, np.ndarray):
            h.update(str(v.dtype).encode() + str(v.shape).encode()
                     + v.tobytes())
        else:
            h.update(repr(v).encode())
    return h.hexdigest()[:16]


def _inputs_digest(cell, seed, tmp_path) -> str:
    """The FASTQ of the cell's pool of chunks, or its BAMs with their
    indexes, made from `seed` at the tests' sizes."""
    _b, _c, cfg, mix = run.cell_files(cell, bench(), sizes=SIZES)
    g, _ = gmod.load_genome(cfg)
    paths = []
    if mix["kind"] == "align":
        chunks = rmod.make_chunks(g, cfg, seed, mix["pool_chunks"],
                                  cfg["chunk_bases"])
        for k, ch in enumerate(chunks):
            fq = [str(tmp_path / f"c{k}_{m}.fq") for m in
                  ((1, 2) if cfg["layout"] == "pe" else (1,))]
            rmod.write_fastq(ch, fq)
            paths += fq
    else:
        tid = mix["region_chrom"]
        region = (tid, mix["region_start"], mix["region_start"]
                  + cfg["pileup_region_bp"])
        for k in range(mix["pool_bams"]):
            recs = rmod.pileup_records(g, cfg, region, mix["depth"], seed + k,
                                       f"s{seed % 100000}b{k}")
            p = str(tmp_path / f"sample{k}.bam")
            bmod.write_bam(p, g.names, np.diff(g.starts).tolist(), recs)
            paths += [p, p + ".bai"]
    return _files_digest(paths)


@pytest.mark.parametrize("cell,seed", sorted(INPUTS))
def test_bench_inputs_are_pinned(cell, seed, tmp_path):
    assert _inputs_digest(cell, seed, tmp_path) == INPUTS[(cell, seed)]


class _Built(Exception):
    """Raised by the planted aligner once it holds the loop's MemOpt."""


@pytest.mark.parametrize("cell,control", sorted(OPTIONS))
def test_bench_align_options_are_pinned(cell, control, cpu, monkeypatch):
    """The MemOpt that the align loop hands the hybrid engine, with and
    without the cell's control, taken from its first call."""
    from benchmark.loops import control_of
    from biscuit_tpu_torch.align import device_engine as de
    got = []

    def capture(opt, *a, **kw):
        got.append(opt)
        raise _Built

    monkeypatch.setattr(de, "process_seqs_hybrid", capture)
    _b, cell_d, _c, _m = run.cell_files(cell)
    with pytest.raises(_Built):
        run.run_cell(cell, 5, 0.1, False, cpu, sizes=SIZES,
                     control=control_of(cell_d) if control else None)
    assert _opt_digest(got[0]) == OPTIONS[(cell, control)]
