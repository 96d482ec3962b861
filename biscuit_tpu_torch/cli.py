"""biscuit_tpu_torch command-line interface.

`align` is the port of biscuit_tpu.cli.main_align (the same options and
batching) running SE and PE reads through the torch device engine
(align/device_engine.process_seqs_device) on the device named by
BISCUIT_TPU_TORCH_DEVICE (default `cuda`; `cpu` runs the plain torch
versions of the kernels). SAM goes to stdout. Every other subcommand is
biscuit_tpu.cli.main unchanged.

    python -m biscuit_tpu_torch.cli align <genome.fa> <reads.fq> > out.sam
    python -m biscuit_tpu_torch.cli align <genome.fa> <r1.fq> <r2.fq> > pe.sam
    python -m biscuit_tpu_torch.cli align -p <genome.fa> <interleaved.fq>
"""
import getopt
import math
import sys

import numpy as np

from biscuit_tpu import __version__


def main_align(argv):
    from biscuit_tpu.config import (
        MemOpt, MEM_F_ALL, MEM_F_KEEP_SUPP_MAPQ, MEM_F_NO_MULTI,
        MEM_F_NOPAIRING, MEM_F_NO_RESCUE, MEM_F_PE, MEM_F_REF_HDR,
        MEM_F_SELF_OVLP, MEM_F_SMARTPE, MEM_F_SOFTCLIP)
    from biscuit_tpu.index.fasta import NT4
    from biscuit_tpu.index.fmindex import BisIndex
    from biscuit_tpu.align import bns as bnsmod
    from biscuit_tpu.io.fastq import fastq_iter, read_batch, make_bseq
    from .align.pair import PeStat
    from .align.pipeline import AlignerState, process_seqs, sam_header
    from .align.device_engine import DeviceAligner, process_seqs_device
    from .device import resolve

    opt = MemOpt()
    opt.flag |= MEM_F_NO_MULTI
    overridden = set()
    seq1 = seq2 = None
    rg_line = hdr_line = None
    rg_id = ""
    auto_infer_alt = True
    ignore_alt = False
    pes0 = None
    no_hdr = False
    mode = None
    verbose = 3

    optstr = "@:1:2:3:5:9ab:c:d:ef:g:hijk:m:pqr:s:v:w:x:y:z:A:B:CD:E:FG:H:I:J:K:L:MN:O:PQ:R:ST:U:VW:X:Y"
    opts, args = getopt.getopt(argv, optstr)
    copy_comment = False
    for o, a in opts:
        c = o[1]
        if c == "k": opt.min_seed_len = int(a); overridden.add("min_seed_len")
        elif c == "1": seq1 = a
        elif c == "2": seq2 = a
        elif c == "b": opt.parent = int(a)
        elif c == "f": opt.bsstrand = int(a)
        elif c == "i": auto_infer_alt = False
        elif c == "w": opt.w = int(a); overridden.add("w")
        elif c == "A": opt.a = int(a); overridden.add("a")
        elif c == "B": opt.b = int(a); overridden.add("b")
        elif c == "T": opt.T = int(a); overridden.add("T")
        elif c == "U": opt.pen_unpaired = int(a); overridden.add("pen_unpaired")
        elif c == "@": opt.n_threads = max(int(a), 1)
        elif c == "P": opt.flag |= MEM_F_NOPAIRING
        elif c == "a": opt.flag |= MEM_F_ALL
        elif c == "p": opt.flag |= MEM_F_PE | MEM_F_SMARTPE
        elif c == "q": opt.flag |= MEM_F_KEEP_SUPP_MAPQ
        elif c == "M": opt.flag |= MEM_F_NO_MULTI
        elif c == "S": opt.flag |= MEM_F_NO_RESCUE
        elif c == "e": opt.flag |= MEM_F_SELF_OVLP
        elif c == "Y": opt.flag |= MEM_F_SOFTCLIP
        elif c == "V": opt.flag |= MEM_F_REF_HDR
        elif c == "c": opt.max_occ = int(a); overridden.add("max_occ")
        elif c == "d": opt.zdrop = int(a); overridden.add("zdrop")
        elif c == "v": verbose = int(a)
        elif c == "x": mode = a
        elif c == "j": ignore_alt = True
        elif c == "r": opt.split_factor = float(a); overridden.add("split_factor")
        elif c == "D": opt.drop_ratio = float(a); overridden.add("drop_ratio")
        elif c == "m": opt.max_matesw = int(a)
        elif c == "s": opt.split_width = int(a)
        elif c == "G": opt.max_chain_gap = int(a)
        elif c == "N": opt.max_chain_extend = int(a); overridden.add("max_chain_extend")
        elif c == "W": opt.min_chain_weight = int(a); overridden.add("min_chain_weight")
        elif c == "y": opt.max_mem_intv = int(a)
        elif c == "C": copy_comment = True
        elif c == "J":
            opt.adaptor1 = NT4[np.frombuffer(a.encode(), dtype=np.uint8)].copy()
        elif c == "K":
            opt.adaptor2 = NT4[np.frombuffer(a.encode(), dtype=np.uint8)].copy()
        elif c == "z": opt.min_base_qual = int(a)
        elif c == "5": opt.clip5 = int(a)
        elif c == "3": opt.clip3 = int(a)
        elif c == "9": opt.has_bc = 1
        elif c == "X": opt.mask_level = float(a)
        elif c == "g":
            parts = a.replace(";", ",").split(",")
            opt.max_XA_hits = opt.max_XA_hits_alt = int(parts[0])
            if len(parts) > 1:
                opt.max_XA_hits_alt = int(parts[1])
        elif c == "Q":
            opt.mapQ_coef_len = int(a)
            # int-truncated like the reference's int mapQ_coef_fac field
            opt.mapQ_coef_fac = int(math.log(opt.mapQ_coef_len)) if opt.mapQ_coef_len > 0 else 0
        elif c == "O":
            parts = a.split(",")
            opt.o_del = opt.o_ins = int(parts[0])
            if len(parts) > 1:
                opt.o_ins = int(parts[1])
            overridden.update(["o_del", "o_ins"])
        elif c == "E":
            parts = a.split(",")
            opt.e_del = opt.e_ins = int(parts[0])
            if len(parts) > 1:
                opt.e_ins = int(parts[1])
            overridden.update(["e_del", "e_ins"])
        elif c == "L":
            parts = a.split(",")
            opt.pen_clip5 = opt.pen_clip3 = int(parts[0])
            if len(parts) > 1:
                opt.pen_clip3 = int(parts[1])
            overridden.update(["pen_clip5", "pen_clip3"])
        elif c == "R":
            rg_line = a.replace("\\t", "\t")
            for fieldv in rg_line.split("\t"):
                if fieldv.startswith("ID:"):
                    rg_id = fieldv[3:]
        elif c == "H":
            if a.startswith("@"):
                ln = a.replace("\\t", "\t")
                hdr_line = ln if hdr_line is None else hdr_line + "\n" + ln
            else:
                with open(a) as f:
                    for ln in f:
                        ln = ln.rstrip("\n")
                        if ln.startswith("@"):
                            hdr_line = ln if hdr_line is None else hdr_line + "\n" + ln
        elif c == "I":
            parts = a.split(",")
            pes0 = PeStat()
            pes0.avg = float(parts[0])
            pes0.std = pes0.avg * 0.1
            if len(parts) > 1:
                pes0.std = float(parts[1])
            pes0.high = int(pes0.avg + 4.0 * pes0.std + 0.499)
            pes0.low = int(pes0.avg - 4.0 * pes0.std + 0.499)
            if len(parts) > 2:
                pes0.high = int(float(parts[2]) + 0.499)
            if len(parts) > 3:
                pes0.low = int(float(parts[3]) + 0.499)
        elif c == "F":
            no_hdr = True  # MEM_F_ALN_REG in reference (table output)
        elif c == "h":
            o = MemOpt()
            print(f"""
Usage: biscuit_tpu align [options] <fai-index base> <in1.fq> [in2.fq]

Algorithm options:
    -@ INT          Number of threads [{o.n_threads}]
    -b INT          Strand policy. PE: 1 = read1->parent, read2->daughter
                        (directional library), 0 = both reads against both
                        strands (non-directional) [0]. SE: 1 = parent only,
                        3 = daughter only, 0 = both [0]. The parent is the
                        bisulfite-converted strand.
    -f INT          Restrict to one bisulfite strand: 1 BSW, 3 BSC, 0 both [0]
    -k INT          Minimum seed length [{o.min_seed_len}]
    -w INT          Band width for banded alignment [{o.w}]
    -d INT          Off-diagonal X-dropoff (z-drop) [{o.zdrop}]
    -r FLOAT        Re-seed inside seeds longer than {{-k}}*FLOAT [{o.split_factor:g}]
    -y INT          Seed occurrence cutoff for the 3rd seeding round [{o.max_mem_intv}]
    -J STR          Read-1 adaptor to trim (fastq direction)
    -K STR          Read-2 adaptor to trim (fastq direction)
    -z INT          Minimum base quality kept at read ends [{o.min_base_qual}]
    -5 INT          Extra bases clipped from the 5' end [{o.clip5}]
    -3 INT          Extra bases clipped from the 3' end [{o.clip3}]
    -c INT          Skip seeds occurring more than INT times [{o.max_occ}]
    -D FLOAT        Drop chains shorter than FLOAT of the longest overlap [{o.drop_ratio:.2f}]
    -W INT          Discard chains with seeded bases shorter than INT [0]
    -m INT          Mate-rescue rounds per read [{o.max_matesw}]
    -S              Skip mate rescue
    -P              Skip pairing (mate rescue still runs unless -S)
    -e              Discard full-length exact matches
    -9              Extract barcode/UMI from the read name

Scoring options:
    -A INT          Match score; scales -TdBOELU unless overridden [{o.a}]
    -B INT          Mismatch penalty [{o.b}]
    -O INT[,INT]    Gap-open penalties (deletion,insertion) [{o.o_del},{o.o_ins}]
    -E INT[,INT]    Gap-extension penalties; gap g costs {{-O}} + {{-E}}*g [{o.e_del},{o.e_ins}]
    -L INT[,INT]    5'/3' clipping penalties [{o.pen_clip5},{o.pen_clip3}]
    -U INT          Unpaired read-pair penalty [{o.pen_unpaired}]

Input/output options:
    -1 STR          Align the literal read STR
    -2 STR          Align STR as the mate of the -1 read
    -i              Disable ALT-chromosome auto-inference
    -p              Smart pairing (interleaved input; in2.fq ignored)
    -R STR          Read-group header line (e.g. '@RG\\tID:foo\\tSM:bar')
    -F              Suppress the SAM header
    -H STR/FILE     Insert a header line (@...) or the @-lines of FILE
    -j              Ignore the .alt file (ALT contigs become primary)
    -q              Keep mapQ of supplementary alignments
    -T INT          Minimum score to output [{o.T}]
    -g INT[,INT]    Maximum XA hits (primary[,alt]) [{o.max_XA_hits},{o.max_XA_hits_alt}]
    -a              Output all alignments for SE / unpaired PE
    -C              Append the FASTQ comment to SAM
    -V              Output the reference FASTA header in the XR tag
    -Y              Soft-clip supplementary alignments
    -M              Mark shorter split hits as secondary
    -I FLOAT[,FLOAT[,INT[,INT]]]
                    Insert-size distribution: mean[,std[,max[,min]]]
                        (std = 10% of mean, max/min = 4 sigma if absent)
    -v INT          Verbosity
    -h              This help
""", file=sys.stderr)
            return 1

    if rg_line:
        hdr_line = rg_line if hdr_line is None else hdr_line + "\n" + rg_line

    if (len(args) < 2 and not seq1) or not args:
        print("Missing index base or FASTQ file", file=sys.stderr)
        return 1

    if mode is not None:
        # -x read-type presets (align.c:476-512); each field applies only if
        # not individually overridden, and update_a is skipped entirely
        ov = overridden
        if mode == "intractg":
            if "o_del" not in ov: opt.o_del = 16
            if "o_ins" not in ov: opt.o_ins = 16
            if "b" not in ov: opt.b = 9
            if "pen_clip5" not in ov: opt.pen_clip5 = 5
            if "pen_clip3" not in ov: opt.pen_clip3 = 5
        elif mode in ("pacbio", "pbref", "pbread", "ont2d"):
            if "o_del" not in ov: opt.o_del = 1
            if "e_del" not in ov: opt.e_del = 1
            if "o_ins" not in ov: opt.o_ins = 1
            if "e_ins" not in ov: opt.e_ins = 1
            if "b" not in ov: opt.b = 1
            if "split_factor" not in ov: opt.split_factor = 10.0
            if mode == "pbread":
                opt.flag |= MEM_F_ALL | MEM_F_SELF_OVLP
                no_hdr = True  # MEM_F_ALN_REG
                if "min_chain_weight" not in ov: opt.min_chain_weight = 40
                if "max_occ" not in ov: opt.max_occ = 1000
                if "min_seed_len" not in ov: opt.min_seed_len = 13
                if "max_chain_extend" not in ov: opt.max_chain_extend = 25
                if "drop_ratio" not in ov: opt.drop_ratio = 0.001
            elif mode == "ont2d":
                if "min_chain_weight" not in ov: opt.min_chain_weight = 20
                if "min_seed_len" not in ov: opt.min_seed_len = 14
                if "pen_clip5" not in ov: opt.pen_clip5 = 0
                if "pen_clip3" not in ov: opt.pen_clip3 = 0
            else:
                if "min_chain_weight" not in ov: opt.min_chain_weight = 40
                if "min_seed_len" not in ov: opt.min_seed_len = 17
                if "pen_clip5" not in ov: opt.pen_clip5 = 0
                if "pen_clip3" not in ov: opt.pen_clip3 = 0
        else:
            print(f"[E::main_align] unknown read type '{mode}'", file=sys.stderr)
            return 1
    elif "a" in overridden:
        opt.update_a(overridden)
    # rebuild scoring matrices with the final a/b
    opt.__post_init__()

    from .align import trace
    from biscuit_tpu.align import trace as jax_pkg_trace
    trace.set_verbose(verbose)
    jax_pkg_trace.set_verbose(verbose)  # read by the shared align/bns.py

    device = resolve()

    idx = BisIndex.load(args[0])
    if verbose >= 3:
        # bwa_idx_load_from_disk (bwa.c:540-544): ALT count from the .alt file
        n_alt = sum(1 for a in idx.anns if getattr(a, "is_alt", 0))
        print(f"[M::bwa_idx_load_from_disk] read {n_alt} ALT contigs",
              file=sys.stderr)
    if auto_infer_alt:
        bnsmod.infer_alt_chromosomes(idx)
    if ignore_alt:
        for ann in idx.anns:
            ann.is_alt = 0

    st = AlignerState(idx)
    out = sys.stdout

    pg = (f"@PG\tID:biscuit_tpu\tPN:biscuit_tpu\tVN:{__version__}"
          f"\tCL:biscuit_tpu align {' '.join(argv)}")
    if not no_hdr:
        out.write(sam_header(idx, hdr_line, pg))

    # debug traces are only wired through the host engine, and ordered
    # output needs a single in-process worker
    dev = None
    if verbose >= 4:
        opt.n_threads = 1
    else:
        dev = DeviceAligner(st, device)

    def run_batch(seqs, n_processed):
        import time as _time
        ct0, rt0 = _time.process_time(), _time.perf_counter()
        if dev is not None:
            process_seqs_device(opt, st, seqs, n_processed, pes0, rg_id,
                                engine=dev)
        else:
            process_seqs(opt, st, seqs, n_processed, pes0, rg_id)
        if verbose >= 3:
            # mem_process_seqs (bwamem.c:474-475)
            print("[M::mem_process_seqs] Processed %d reads in %.3f CPU sec,"
                  " %.3f real sec" % (len(seqs), _time.process_time() - ct0,
                                      _time.perf_counter() - rt0),
                  file=sys.stderr)

    if seq1 is not None:
        seqs = [make_bseq("inputread", None, seq1, None)]
        if seq2 is not None:
            seqs.append(make_bseq("inputread", None, seq2, None))
            opt.flag |= MEM_F_PE
        run_batch(seqs, 0)
        for s in seqs:
            if s.sam:
                out.write(s.sam)
        return 0

    it1 = fastq_iter(args[1])
    it2 = None
    if len(args) > 2:
        if opt.flag & MEM_F_SMARTPE:
            print("[W] when '-p' is in use, the second query file is ignored.",
                  file=sys.stderr)
        else:
            it2 = fastq_iter(args[2])
            opt.flag |= MEM_F_PE
    n_processed = 0
    chunk = opt.chunk_size * opt.n_threads
    # kt_pipeline equivalent (reference align.c:577 + kthread.c:176-256):
    # a reader thread prefetches the next FASTQ batch while the current one
    # aligns, with ordered output.
    import queue
    import threading
    bq: "queue.Queue" = queue.Queue(maxsize=1)

    def _reader():
        try:
            while True:
                batch = read_batch(it1, it2, chunk, bool(opt.has_bc))
                bq.put(batch)
                if not batch:
                    break
        except BaseException as e:  # surface IO errors in the main thread
            bq.put(e)

    rt = threading.Thread(target=_reader, daemon=True)
    rt.start()
    while True:
        seqs = bq.get()
        if isinstance(seqs, BaseException):
            raise seqs
        if not seqs:
            break
        if not copy_comment:
            for s in seqs:
                s.comment = None
        print(f"[M::process] read {len(seqs)} sequences ({sum(s.l_seq for s in seqs)} bp)...",
              file=sys.stderr)
        run_batch(seqs, n_processed)
        n_processed += len(seqs)
        for s in seqs:
            if s.sam:
                out.write(s.sam)
    rt.join()
    return 0


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if argv and argv[0] == "align":
        return main_align(argv[1:])
    from biscuit_tpu.cli import main as jax_pkg_main
    return jax_pkg_main(argv)


if __name__ == "__main__":
    sys.exit(main())
