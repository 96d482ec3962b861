#!/usr/bin/env python3
"""Multi-host data-parallel pileup driver over the port — the
coordinate-axis analog of shard_align.py (SURVEY.md §2d).

Shards the genome BY CHROMOSOME across N worker processes (each host runs
`biscuit_tpu_torch pileup -g <chrom>` with the same reference + BAM; a real
deployment points each worker at its own host), then:
  * concatenates the VCF bodies in the single-process chromosome order —
    the reference's window-merge ownership rules make per-region outputs
    concat-exact (src/pileup.c:1153-1204), so the merged VCF is
    byte-identical to one whole-genome run (modulo the ##program CL);
  * merges the _meth_average.tsv side-stats from each worker's RAW
    accumulator dump (BISCUIT_TPU_TORCH_MA_RAW), so per-chromosome rows AND
    the WholeGenome row are recomputed from exact sums, not re-averaged
    from rounded percentages.

Copy of tools/shard_pileup.py over the port: its workers run `python -m
biscuit_tpu_torch.cli pileup` (the engine of BISCUIT_TPU_TORCH_PILEUP, on
the device of BISCUIT_TPU_TORCH_DEVICE), and REPO, the repository's root,
lies one directory further up. tests/test_torch_engine.py holds the copy
to its source.

Usage (from the repository's root):
    python -m biscuit_tpu_torch.tools.shard_pileup -n 4 -o out.vcf [pileup options...] ref.fa in.bam
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=os.cpu_count() or 2,
                    help="number of worker processes (one per 'host')")
    ap.add_argument("-o", required=True, help="merged output VCF")
    ap.add_argument("rest", nargs=argparse.REMAINDER,
                    help="pileup options + ref.fa + in.bam")
    args, unknown = ap.parse_known_args()
    rest = unknown + args.rest
    if len(rest) < 2:
        print("need: [pileup options...] ref.fa in.bam", file=sys.stderr)
        return 1
    opts, pos = rest[:-2], rest[-2:]
    fa, bam = pos

    from biscuit_tpu_torch.io.sambam import AlignmentFile
    from biscuit_tpu_torch.pileup.engine import meth_average_table, NCONTXTS

    hdr = AlignmentFile(bam).header
    chroms = list(hdr.names)

    tmpd = tempfile.mkdtemp(prefix="btshardplp")
    env = dict(os.environ, PYTHONPATH=REPO)
    # one worker per chromosome slot, round-robined over n process slots;
    # workers run concurrently in waves of n
    jobs = []
    for ci, chrom in enumerate(chroms):
        ovcf = os.path.join(tmpd, f"c{ci}.vcf")
        raw = os.path.join(tmpd, f"c{ci}.raw.json")
        e = dict(env, BISCUIT_TPU_TORCH_MA_RAW=raw)
        cmd = [sys.executable, "-m", "biscuit_tpu_torch.cli", "pileup",
               "-g", chrom, "-o", ovcf] + opts + [fa, bam]
        jobs.append((ci, chrom, ovcf, raw, cmd, e))

    running = []
    failed = []

    def reap(block):
        for p, ci in running[:]:
            rc = p.wait() if block else p.poll()
            if rc is None:
                continue
            running.remove((p, ci))
            if rc != 0:
                failed.append(ci)

    for ci, chrom, ovcf, raw, cmd, e in jobs:
        while len(running) >= max(1, args.n):
            reap(block=True)
        running.append((subprocess.Popen(
            cmd, env=e, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL), ci))
    while running:
        reap(block=True)
    if failed:
        print(f"workers failed for chromosomes {failed}", file=sys.stderr)
        return 1

    # ordered VCF merge: header from shard 0 (drop its -g CL line), bodies
    # in chromosome order
    with open(args.o, "w") as out:
        for i, (ci, chrom, ovcf, raw, cmd, e) in enumerate(jobs):
            with open(ovcf) as f:
                for line in f:
                    if line.startswith("#"):
                        if i == 0:
                            if line.startswith("##program="):
                                line = ("##program=" + " ".join(
                                    ["shard_pileup.py"] + sys.argv[1:]) + "\n")
                            out.write(line)
                        continue
                    out.write(line)

    # meth_average from exact merged sums
    merged = {}   # sample -> chrom -> {betasum, cnt}
    is_nome = 0
    for ci, chrom, ovcf, raw, cmd, e in jobs:
        with open(raw) as f:
            d = json.load(f)
        is_nome = d["is_nome"]
        for sample, per in d["stats"].items():
            ms = merged.setdefault(sample, {})
            for cname, sc in per.items():
                t = ms.setdefault(cname, {"betasum": [0.0] * NCONTXTS,
                                          "cnt": [0] * NCONTXTS})
                for k in range(NCONTXTS):
                    t["betasum"][k] += sc["betasum"][k]
                    t["cnt"][k] += sc["cnt"][k]

    class _Conf:
        class comm:
            pass
    conf = _Conf()
    conf.comm.is_nome = is_nome
    targets = sorted(range(len(hdr.names)), key=lambda tid: hdr.names[tid])
    names = [(hdr.names[targets[t]], hdr.lengths[t]) for t in targets]
    with open(args.o + "_meth_average.tsv", "w") as f:
        if is_nome:
            f.write("sample\tchrm\tHCGn\tHCGb\tHCHGn\tHCHGb\tHCHHn\tHCHHb\tHCHn\tHCHb\tGCn\tGCb\n")
        else:
            f.write("sample\tchrm\tCGn\tCGb\tCHGn\tCHGb\tCHHn\tCHHb\tCHn\tCHb\n")
        for sample, per in merged.items():
            # reproduce the CLI's (reference bug-compatible) by-row-index
            # stat selection: data at index k, name via double indexing
            by_row_beta = {}
            by_row_cnt = {}
            for k in range(len(targets)):
                cname = hdr.names[k]
                sc = per.get(cname, {"betasum": [0.0] * NCONTXTS,
                                     "cnt": [0] * NCONTXTS})
                by_row_beta[k] = sc["betasum"]
                by_row_cnt[k] = sc["cnt"]
            for line in meth_average_table(conf, sample, names,
                                           by_row_beta, by_row_cnt):
                f.write(line)
    print(f"merged {len(chroms)} chromosome shards -> {args.o}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
