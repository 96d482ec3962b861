"""The `device` pileup engine's C++ walk over raw BAM records
(pileup/walk.py over pileup/walk_host.cpp), on the CPU with K9's plain
version.

Each case runs the port's `pileup` CLI in this process three times: the
`device` engine on BAM input (the walk), the `device` engine on the same
records as a sorted SAM (the Python walk, `_pileup_window_fast`) and the
`native` engine on the BAM. The VCF (without its `##program` line, which
holds the output's path) and the `_meth_average.tsv` must be the same
bytes in all three. The BAM and the SAM of a sample lie in directories of
their own under one name, and each run starts in its input's directory,
so the sample names in the outputs agree. The records carry what the walk
must handle: reads with QUAL `*`, mates without an MC tag, duplicate,
secondary and improperly paired flags, a stretch of chr1 with no read (an
empty 4 kbp window), reads across window boundaries. The walk must hand
`_device_counts`, the count both walks share, the data of every window
that `_pileup_window_fast` hands it; a fault planted there must reach the
walk's output; the walk's record loop must be the pinned copy's but for its
marked lines; and `STAGES["raw_windows"]` must count the walk's windows and
no other engine's.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from biscuit_tpu_torch import cli
from biscuit_tpu_torch.io.sambam import AlignmentFile
from biscuit_tpu_torch.pileup import engine as tengine
from biscuit_tpu_torch.pileup import walk
from biscuit_tpu_torch.pileup.common import NCONTXTS, RefCache
from biscuit_tpu_torch.pileup.native import RawBam, RawBamStream, raw_bam_open

from torch_testdata import make_dataset, run_cli

torch.set_num_threads(1)

CPU = torch.device("cpu")
EMPTY = (11000, 17000)   # chr1 positions where no read starts


def _edit(body):
    """The aligned records with the walk's edge cases put in: every 7th
    record's QUAL `*`, every 5th without its MC tag, every 11th flagged a
    duplicate, every 13th an improper pair, every 17th secondary, every
    third mate 2 with its mate placed 40 bp after it (the generator's
    mates never overlap: their fragments are at least two reads long); no
    record of chr1 starting inside EMPTY."""
    out = []
    for i, ln in enumerate(body):
        f = ln.rstrip("\n").split("\t")
        if f[2] == "chr1" and EMPTY[0] <= int(f[3]) < EMPTY[1]:
            continue
        flag = int(f[1])
        if flag & 4:
            continue
        if i % 7 == 0:
            f[10] = "*"
        if i % 5 == 0:
            f = f[:11] + [t for t in f[11:] if not t.startswith("MC:Z:")]
        if i % 11 == 0:
            flag |= 0x400
        if i % 13 == 0:
            flag &= ~0x2
        if i % 17 == 0:
            flag |= 0x100
        if flag & 0x80 and i % 3 == 0:
            f[7] = str(int(f[3]) + 40)
        f[1] = str(flag)
        out.append("\t".join(f) + "\n")
    return out


def _sorted_sam(path, head, body):
    order = [ln.split("\t")[1][3:] for ln in head if ln.startswith("@SQ")]
    key = lambda ln: (order.index(ln.split("\t")[2]), int(ln.split("\t")[3]))
    with open(path, "w") as f:
        f.writelines(head)
        f.writelines(sorted(body, key=key))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 30 kbp genome of 2 chromosomes, 300 pairs of 100 bp directional WGBS
    reads with SNPs at 1%, aligned by the port's native engine, edited
    (_edit) and sorted: samples `s` (every record) and `h` (every other
    pair, written twice), each as `bam/<name>.bam` with its .bai,
    `nobai/<name>.bam` without one, and `sam/<name>.bam`, a sorted SAM
    under the BAM's name."""
    d = tmp_path_factory.mktemp("tplpw")
    fa, (fq1, fq2), _ = make_dataset(d, genome_size=30000, n_reads=300,
                                     seed=13, read_len=100, snp_rate=0.01,
                                     pe=True, index=False)
    run_cli("biscuit_tpu_torch", ["index", fa])
    sam = run_cli("biscuit_tpu_torch", ["align", fa, fq1, fq2],
                  BISCUIT_TPU_TORCH_ENGINE="native").stdout.splitlines(True)
    head = [ln for ln in sam if ln[0] == "@"]
    body = _edit([ln for ln in sam if ln[0] != "@"])
    half = [ln for i, ln in enumerate(body) if i // 2 % 2 == 0
            for _ in range(2)]
    for sub in ("bam", "nobai", "sam"):
        os.makedirs(d / sub)
    for name, recs in (("s", body), ("h", half)):
        raw = str(d / f"{name}.sam")
        _sorted_sam(raw, head, recs)
        _sorted_sam(str(d / "sam" / f"{name}.bam"), head, recs)
        bam = str(d / "bam" / f"{name}.bam")
        run_cli("biscuit_tpu_torch", ["sort", "-o", bam, raw])
        run_cli("biscuit_tpu_torch", ["bamindex", bam])
        shutil.copyfile(bam, d / "nobai" / f"{name}.bam")
    fields = [ln.split("\t") for ln in body]
    assert sum(f[10] == "*" for f in fields) > 50
    assert sum(not any(t.startswith("MC:Z:") for t in f) for f in fields) > 50
    assert sum(int(f[1]) & 0x80 and int(f[7]) == int(f[3]) + 40
               for f in fields) > 50
    return {"fa": fa, "dir": str(d)}


# id -> (options, the inputs after the reference), named as in the run's
# directory
CASES = {
    "one_sample": (["-@", "1"], ["s.bam"]),
    "two_samples": (["-@", "1"], ["s.bam", "h.bam"]),
    "nome": (["-N", "-@", "1"], ["s.bam"]),
    "somatic": (["-S", "-T", "s.bam", "-I", "h.bam", "-@", "1"], []),
    "filters_off": (["-d", "-p", "-u", "-c", "-@", "1"], ["s.bam", "h.bam"]),
    "base_qual_0": (["-b", "0", "-@", "1"], ["s.bam"]),
    "read_ends_0": (["-5", "0", "-3", "0", "-@", "1"], ["s.bam"]),
    "windows": (["-s", "4000", "-@", "1"], ["s.bam", "h.bam"]),
    "region": (["-g", "chr1:1500-20000", "-s", "4000", "-@", "1"],
               ["s.bam"]),
    "pooled": (["-s", "4000", "-@", "3"], ["s.bam", "h.bam"]),
}
_RUNS = {}   # (case, where, engine, verbose) -> (VCF, tsv, STAGES)


def _pileup(data, monkeypatch, case, where, engine, verbose=False):
    """`pileup` of CASES[case] in this process from directory `where`
    (bam, nobai or sam) under `engine`: the VCF without ##program, the tsv
    and the stage counters."""
    key = (case, where, engine, verbose)
    if key not in _RUNS:
        opts, inputs = CASES[case]
        out = os.path.join(data["dir"], "_".join(map(str, key)) + ".vcf")
        monkeypatch.chdir(os.path.join(data["dir"], where))
        monkeypatch.setenv("BISCUIT_TPU_TORCH_DEVICE", "cpu")
        monkeypatch.setenv(cli.PILEUP_ENV, engine)
        tengine.reset_stages()
        argv = ["pileup", *opts, *(["-v", "1"] if verbose else []), "-o",
                out, data["fa"], *inputs]
        assert cli.main(argv) == 0
        with open(out) as f:
            vcf = [ln for ln in f if not ln.startswith("##program")]
        with open(out + "_meth_average.tsv") as f:
            _RUNS[key] = (vcf, f.read(), dict(tengine.STAGES))
    return _RUNS[key]


@pytest.mark.parametrize("case", list(CASES))
def test_walk_writes_the_python_walks_and_the_native_engines_output(
        data, monkeypatch, case):
    walked = _pileup(data, monkeypatch, case, "bam", "device")
    python = _pileup(data, monkeypatch, case, "sam", "device")
    native = _pileup(data, monkeypatch, case, "bam", "native")
    assert walked[:2] == python[:2] == native[:2]
    body = [ln for ln in walked[0] if ln[0] != "#"]
    assert len(body) > (300 if case == "region" else 1000)
    assert sum("CV:BT" in ln for ln in body) > len(body) // 3
    assert walked[1].count("\n") >= 3
    if case in ("windows", "region"):   # nothing inside the empty stretch
        pos = [int(ln.split("\t")[1]) for ln in body
               if ln.startswith("chr1\t")]
        assert not [p for p in pos if EMPTY[0] + 200 <= p < EMPTY[1]]
    st, py = walked[2], python[2]
    if case != "pooled":   # the pool's windows count in its workers
        assert st["raw_windows"] == st["windows"] > 0
        assert st["data"] > 10000 and st["count"] > 0
        assert st["sites"] == len(body)
    assert st["native"] == 0 and py["raw_windows"] == 0
    assert native[2]["raw_windows"] == 0


def test_walk_without_a_bai_reads_the_whole_blob(data, monkeypatch):
    """A BAM without a .bai opens as RawBam, with one as RawBamStream; the
    walk gives both the same output."""
    d = data["dir"]
    assert type(raw_bam_open(os.path.join(d, "bam", "s.bam"))) is RawBamStream
    assert type(raw_bam_open(os.path.join(d, "nobai", "s.bam"))) is RawBam
    whole = _pileup(data, monkeypatch, "windows", "nobai", "device")
    assert whole[:2] == _pileup(data, monkeypatch, "windows", "bam",
                                "device")[:2]
    assert whole[2]["raw_windows"] == whole[2]["windows"] > 0


@pytest.mark.parametrize("how", ["verbose", "mesh"])
def test_verbose_and_mesh_keep_the_python_walk(data, monkeypatch, how):
    """-v 1 and a one-rank `mesh` take the Python walk on BAM input: no
    window of the C++ walk, and the output of the same run on the SAM."""
    engine = "mesh" if how == "mesh" else "device"
    verbose = how == "verbose"
    got = _pileup(data, monkeypatch, "two_samples", "bam", engine, verbose)
    want = _pileup(data, monkeypatch, "two_samples", "sam", "device", verbose)
    assert got[:2] == want[:2]
    assert got[2]["raw_windows"] == 0
    if verbose:
        body = [ln for ln in got[0] if ln[0] != "#"]
        assert body and all("DIAGNOSE" in ln for ln in body)
    else:
        assert got[2]["windows"] > 0
        assert got[:2] == _pileup(data, monkeypatch, "two_samples", "bam",
                                  "device")[:2]


@pytest.mark.parametrize("names", [("s",), ("s", "h")],
                         ids=["one_sample", "two_samples"])
def test_walk_stages_the_python_walks_data(data, monkeypatch, names):
    """Window by window (4 kbp, the empty one among them): the walk hands
    `_device_counts` the data `_pileup_window_fast` hands it (the same site
    offsets, samples, stats and pass flags, as a multiset), K9's plain
    version counts them the same, and the window's text and context sums
    are the same."""
    d = data["dir"]
    paths = [os.path.join(d, "bam", n + ".bam") for n in names]
    objs, raws = [AlignmentFile(p) for p in paths], [raw_bam_open(p)
                                                      for p in paths]
    rs, conf, nb = RefCache(data["fa"]), tengine.PileupConf(), len(names)
    hdr = objs[0].header
    caught = []
    real = tengine._device_counts

    def spy(*a):
        out = real(*a)
        caught.append((a, out))
        return out
    monkeypatch.setattr(tengine, "_device_counts", spy)
    empty = full = 0
    for t in range(len(hdr.names)):
        for beg in range(1, hdr.lengths[t], 4000):
            end = min(beg + 4000, hdr.lengths[t])
            caught.clear()
            outs = []
            for bams in (objs, raws):
                bs = [[0.0] * NCONTXTS for _ in names]
                cs = [[0] * NCONTXTS for _ in names]
                outs.append((tengine.pileup_window(
                    bams, rs, conf, t, hdr.names[t], beg, end, bs, cs, CPU),
                    bs, cs))
            assert outs[0] == outs[1]
            if not caught:   # neither walk's window had data
                assert outs[0][0] == "" and not len(walk.stage(
                    raws, rs, conf, t, hdr.names[t], beg, end)[0])
                empty += 1
                continue
            (py, py_counts), (wk, wk_counts) = caught
            assert py[4:6] == wk[4:6] == (end - beg, nb)
            assert wk[0].dtype == wk[1].dtype == np.int32
            assert wk[2].dtype == np.uint8 and wk[3].dtype == bool
            want, got = (np.stack([a.astype(np.int64) for a in x[:4]])
                         for x in (py, wk))
            assert np.array_equal(want[:, np.lexsort(want)],
                                  got[:, np.lexsort(got)])
            for g, w in zip(wk_counts, py_counts):
                assert np.array_equal(g, w)
            full += 1
    assert empty == 1 and full == 7


def _fault(kind):
    """A fault planted in `_device_counts`: the previous window's counts, half
    the data, one count altered."""
    real = tengine._device_counts
    last = []

    def faulty(p, sid, stat, passm, P, n_bams, device):
        if kind == "half_left_out":
            return real(p[::2], sid[::2], stat[::2], passm[::2], P, n_bams,
                        device)
        out = real(p, sid, stat, passm, P, n_bams, device)
        if kind == "state_unchanged":
            if last and last[-1][0].shape == out[0].shape:
                out = last[-1]
            last.append(out)
        else:
            cm, cb, dp = (a.copy() for a in out)
            cm[int(np.nonzero(dp[:, 0])[0][0]), 0, 0] += 1
            out = (cm, cb, dp)
        return out
    return faulty


@pytest.mark.parametrize("kind", ["state_unchanged", "half_left_out",
                                  "answer_altered"])
def test_walk_counts_through_device_counts(data, monkeypatch, kind):
    """The walk's count is `_device_counts`, the Python walk's: a fault
    planted there changes the walk's VCF."""
    good = _pileup(data, monkeypatch, "windows", "bam", "device")
    monkeypatch.setattr(tengine, "_device_counts", _fault(kind))
    opts, inputs = CASES["windows"]
    out = os.path.join(data["dir"], f"fault_{kind}.vcf")
    monkeypatch.chdir(os.path.join(data["dir"], "bam"))
    monkeypatch.setenv("BISCUIT_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv(cli.PILEUP_ENV, "device")
    tengine.reset_stages()
    assert cli.main(["pileup", *opts, "-o", out, data["fa"], *inputs]) == 0
    with open(out) as f:
        vcf = [ln for ln in f if not ln.startswith("##program")]
    assert tengine.STAGES["raw_windows"] == tengine.STAGES["windows"] > 0
    assert vcf != good[0]


def _loop(text, head):
    """The record loop of the function that starts at `head`: from its
    `RawRec b;` line to the `    }` that closes the loop over samples."""
    lines = text[text.index(head):].splitlines()
    i = lines.index("    RawRec b;")
    return lines[i:lines.index("    }", i) + 1]


def test_walk_record_loop_is_the_copys_but_its_stage_lines():
    """bt_walk_stage's record loop is bt_pileup_window_raw's line for line
    (native/pileup_native.cpp, the pinned copy), but for its lines marked
    `// stage`, which stand where the copy counts a datum."""
    here = os.path.dirname(walk.__file__)
    with open(os.path.join(here, "walk_host.cpp")) as f:
        port = _loop(f.read(), "int64_t bt_walk_stage(")
    with open(os.path.join(here, "..", "native", "pileup_native.cpp")) as f:
        copy = _loop(f.read(), "int bt_pileup_window_raw(")
    first = copy.index("                        int64_t p = rp - beg;")
    last = copy.index("                        cb[(p * nbam + sid) * NBASE "
                      "+ base] += 1;")
    marked = [i for i, ln in enumerate(port) if ln.endswith("  // stage")]
    assert len(marked) == 10 and marked == list(range(marked[0],
                                                      marked[-1] + 1))
    assert port[:marked[0]] == copy[:first]
    assert port[marked[-1] + 1:] == copy[last + 1:]
