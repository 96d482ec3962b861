"""biscuit_tpu_torch command-line interface.

The counterparts of every subcommand of biscuit_tpu.cli, with the same
options and the same output. `align` runs SE and PE reads through the
engine named by BISCUIT_TPU_TORCH_ENGINE (default `device`, the hybrid
engine: seeds from the device into the native C++ engine; `device-jax`,
`native` and `host` when named; see ENGINES). `pileup` runs the engine
named by BISCUIT_TPU_TORCH_PILEUP (see PILEUP_ENGINES): `device` (the
default), which makes the count matrices of every window
(ops/pileup_count.py) on the device named by BISCUIT_TPU_TORCH_DEVICE
(default `cuda`; `cpu` runs the plain torch versions of the kernels),
`native`, the C++ window engine, or `mesh`, the device engine's counts
summed over the ranks of a torchrun process group, when named. The sharded
drivers (biscuit_tpu_torch/tools/) steer `align` with
BISCUIT_TPU_TORCH_FASTQ_STRIDE and BISCUIT_TPU_TORCH_PES_EXCHANGE and read
`pileup`'s raw stats from BISCUIT_TPU_TORCH_MA_RAW. Under
BISCUIT_TPU_TORCH_INDEX_SHARD=n `align`'s device engines seed on an FM
index sharded over n ranks (the source's BISCUIT_TPU_INDEX_SHARD): started
as WORLD_SIZE ranks with torchrun's variables, a multiple of n above 1 (any
other WORLD_SIZE exits 1), every rank reads every chunk and makes the same
seeding calls, and rank 0 alone writes the SAM and the [M::...] lines. `vcf2bed` and
`mergecg` run their C++ line filters unless
BISCUIT_TPU_TORCH_STREAMS=python; `epiread`
runs the C++ raw-BAM window engine on BAM input unless
BISCUIT_TPU_TORCH_PILEUP=device names its Python window walk (epiread has
no kernel). None of those five uses torch, and neither does the QC family
(`bsstrand`, `bsconv`, `cinread`, `qc`, `tview`, `bc`): host code over the
BAM, as in biscuit_tpu. SAM and VCF go to stdout unless `-o` names a file.
A name that is no subcommand is answered as biscuit_tpu.cli answers it:
"Unknown subcommand: <name>" on stderr and exit code 1.

    python -m biscuit_tpu_torch.cli index <genome.fa>
    python -m biscuit_tpu_torch.cli align <genome.fa> <reads.fq> > out.sam
    python -m biscuit_tpu_torch.cli align <genome.fa> <r1.fq> <r2.fq> > pe.sam
    python -m biscuit_tpu_torch.cli align -p <genome.fa> <interleaved.fq>
    python -m biscuit_tpu_torch.cli sort -o out.bam out.sam
    python -m biscuit_tpu_torch.cli pileup -o out.vcf <genome.fa> out.bam
"""
import getopt
import math
import os
import sys
import time

import numpy as np

from . import __version__, REFERENCE_VERSION


def main_index(argv):
    from .index.build import build_index
    prefix = None
    mmap_fmt = False
    opts, args = getopt.getopt(argv, "6a:p:Mh")
    for o, a in opts:
        if o == "-p":
            prefix = a
        elif o == "-M":
            # memory-mapped layout (bwashm equivalent): instant load, pages
            # shared across concurrent processes
            mmap_fmt = True
        elif o == "-h":
            print("Usage: biscuit_tpu index [options] <in.fasta>\n"
                  "  -p STR  index prefix (default: the FASTA path)\n"
                  "  -M      write the memory-mappable layout (<prefix>.btidx/)",
                  file=sys.stderr)
            return 1
    if not args:
        print("Missing FASTA reference", file=sys.stderr)
        return 1
    fasta = args[0]
    if prefix is None:
        prefix = fasta
    if mmap_fmt:
        idx = build_index(fasta, prefix=None)
        idx.save_mmap(prefix)
    else:
        build_index(fasta, prefix=prefix)
    return 0


# align's engines, picked by BISCUIT_TPU_TORCH_ENGINE (default `device`):
# device      the hybrid engine: seeds (K3) and SA positions (K4) from the
#             device, chaining, extension and SAM in the native C++ engine
# device-jax  the device engine: every worker1 stage on the device, driven
#             by the host engine's Python (the JAX package's device-jax)
# native      the native C++ engine alone, on the host
# host        the host engine, Python (also what -v 4 and above run)
ENGINE_ENV = "BISCUIT_TPU_TORCH_ENGINE"
ENGINES = ("device", "device-jax", "native", "host")
# the sharded drivers' switches of `align` (biscuit_tpu_torch/tools/
# shard_align.py): the records k, k+n, ... of the input (k:n), and the PE
# insert-size exchange across ranks (dir:rank:n)
STRIDE_ENV = "BISCUIT_TPU_TORCH_FASTQ_STRIDE"
EXCHANGE_ENV = "BISCUIT_TPU_TORCH_PES_EXCHANGE"


class _NoInfo:
    """stderr of a rank other than 0 of an index-sharded `align`: every
    line but the [M::...] ones, which rank 0 alone prints."""

    def __init__(self, err):
        self.err, self.part = err, ""

    def write(self, text):
        self.part += text
        *lines, self.part = self.part.split("\n")
        for ln in lines:
            if not ln.startswith("[M::"):
                self.err.write(ln + "\n")
        return len(text)

    def flush(self):
        self.err.flush()


def main_align(argv):
    from .config import (
        MemOpt, MEM_F_ALL, MEM_F_KEEP_SUPP_MAPQ, MEM_F_NO_MULTI,
        MEM_F_NOPAIRING, MEM_F_NO_RESCUE, MEM_F_PE, MEM_F_REF_HDR,
        MEM_F_SELF_OVLP, MEM_F_SMARTPE, MEM_F_SOFTCLIP)
    from .index.fasta import NT4
    from .index.fmindex import BisIndex
    from .align import bns as bnsmod
    from .io.fastq import fastq_iter, read_batch, make_bseq
    from .align.pair import PeStat
    from .align.pipeline import AlignerState, process_seqs, sam_header
    from .align.device_engine import (DeviceAligner, DeviceSeeder,
                                      process_seqs_device, process_seqs_hybrid)
    from .align.native_engine import process_seqs_native
    from .align.traced_native import traced
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
    trace.set_verbose(verbose)

    # multi-host PE determinism: pool candidate insert sizes across shard
    # ranks so every rank computes the same pes (biscuit_tpu_torch/tools/
    # shard_align.py sets BISCUIT_TPU_TORCH_PES_EXCHANGE=dir:rank:n)
    from .parallel.exchange import from_env as _exchange_from_env
    _ex = _exchange_from_env()
    if _ex is not None:
        from .align import pair as _pairmod
        _pairmod.ISIZE_EXCHANGE = _ex

    engine = os.environ.get(ENGINE_ENV, "device")
    if engine not in ENGINES:
        print(f"[E::main_align] unknown engine '{engine}' in {ENGINE_ENV} "
              f"(one of {', '.join(ENGINES)})", file=sys.stderr)
        return 1
    if verbose >= 4:
        # debug traces are only wired through the host engine, and ordered
        # output needs a single in-process worker
        engine = "host"
        opt.n_threads = 1
    device = resolve() if engine in ("device", "device-jax") else None
    # BISCUIT_TPU_TORCH_INDEX_SHARD=n: the device engines seed on this
    # rank's shard of the tables (parallel.mesh.index_shard_mesh); as in
    # the source, the switch steers nothing else
    mesh, writes = None, True
    if device is not None:
        from .parallel.mesh import index_shard_mesh
        try:
            mesh = index_shard_mesh(device)
        except ValueError as e:
            print(f"[E::main_align] {e}", file=sys.stderr)
            return 1
        if mesh is not None:
            import torch.distributed as dist
            device, writes = mesh.device, dist.get_rank() == 0
            if not writes:
                sys.stderr = _NoInfo(sys.stderr)

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
    out = sys.stdout if writes else open(os.devnull, "w")

    pg = (f"@PG\tID:biscuit_tpu\tPN:biscuit_tpu\tVN:{__version__}"
          f"\tCL:biscuit_tpu align {' '.join(argv)}")
    if not no_hdr:
        out.write(sam_header(idx, hdr_line, pg))

    dev = nat = sdr = None
    if engine == "device":
        nat, sdr = traced(None, st), DeviceSeeder(st, device, mesh)
    elif engine == "device-jax":
        dev = DeviceAligner(st, device, mesh=mesh)
    elif engine == "native":
        nat = traced(None, st)

    def run_batch(seqs, n_processed):
        import time as _time
        ct0, rt0 = _time.process_time(), _time.perf_counter()
        if engine == "device":
            process_seqs_hybrid(opt, st, seqs, n_processed, pes0, rg_id,
                                engine=nat, seeder=sdr, seed_only=not writes)
        elif engine == "device-jax":
            process_seqs_device(opt, st, seqs, n_processed, pes0, rg_id,
                                engine=dev)
        elif engine == "native":
            process_seqs_native(opt, st, seqs, n_processed, pes0, rg_id,
                                engine=nat)
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
        _leave(mesh)
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
    # BISCUIT_TPU_TORCH_FASTQ_STRIDE=k:n — this worker owns records k, k+n,
    # k+2n, ... of the (shared) input. The multi-host data-parallel layer
    # (biscuit_tpu_torch/tools/shard_align.py) uses this so every worker
    # streams the SAME fastq: no serial sharding pass, no temp shard files.
    # With -1/-2 the stride applies per file, keeping mates paired; with -p
    # (smart pairing, interleaved mates in ONE file) it strides by PAIR
    # groups — a per-record stride would hand all read-1s to one worker and
    # silently mispair (pairing is positional: mem_process_seqs pairs
    # records 2i, 2i+1).
    stride = os.environ.get(STRIDE_ENV)
    if stride:
        k_s, n_s = (int(x) for x in stride.split(":"))
        grp = 2 if (opt.flag & MEM_F_SMARTPE) else 1

        def _strided(it, k=k_s, n=n_s, g=grp):
            for i, rec in enumerate(it):
                if (i // g) % n == k:
                    yield rec
        it1 = _strided(it1)
        if it2 is not None:
            it2 = _strided(it2)
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
    report_launches("main_align")
    _leave(mesh)
    return 0


def _leave(mesh) -> None:
    """Leave the process group an index-sharded `align` joined."""
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()


def report_launches(who: str) -> None:
    """The kernels this process launched, as one line on stderr, where it
    launched any (a run on the card): what a check of the sharded drivers
    and of the mesh's ranks reads. Where a routed walk ran (an index sharded
    over ranks), a second line: for each step kernel its walks, their steps
    and the rows they asked for, and the walks' whole calls in ms
    (seed_batch.ROUTED_CALLS, ROUTED_STEPS, ROUTED_ROWS, ROUTED_MS)."""
    import json
    k = sys.modules.get(__package__ + ".kernels")
    launched = {n: v for n, v in (k.LAUNCHES.items() if k else ()) if v}
    if launched:
        print(f"[{who}] kernel launches: {json.dumps(launched, sort_keys=True)}",
              file=sys.stderr)
    sb = sys.modules.get(__package__ + ".ops.seed_batch")
    if sb is not None and any(sb.ROUTED_STEPS.values()):
        walks = {n: {"calls": sb.ROUTED_CALLS[n], "steps": sb.ROUTED_STEPS[n],
                     "rows": sb.ROUTED_ROWS[n],
                     "call_ms": sb.ROUTED_MS[n]} for n in sb.ROUTED_STEPS}
        print(f"[{who}] routed walks: {json.dumps(walks, sort_keys=True)}",
              file=sys.stderr)


# pileup's engines, picked by BISCUIT_TPU_TORCH_PILEUP (default
# PILEUP_DEFAULT):
# device  the count matrices of every window made on the device named by
#         BISCUIT_TPU_TORCH_DEVICE (K9, ops/pileup_count.py); on BAM input
#         the rest of the window is one C++ walk over the raw records
#         (pileup/walk.py), on SAM input Python
# native  the C++ window engine (native/pileup_native.cpp) on raw BAM
#         records, read from the decompressed BAM or, where a .bai lies
#         beside it, block by block; on record objects for SAM input. No
#         torch, no device
# mesh    the `device` engine's counts over the ranks of a process group
#         (parallel/mesh.py): each rank counts its slice of a window's data
#         with K9's fused window count and the counts are summed across
#         ranks.
#         Started by torchrun (WORLD_SIZE above 1) the CLI joins its group
#         (init_process_group("env://"), nccl where every rank has a card
#         of its own, else gloo) and rank 0 alone writes the VCF and the
#         stats; otherwise the mesh is this process alone
# -v above 0 runs the per-datum Python path under all three. epiread reads
# the same switch (main_epiread): `native`, its default, is its C++ raw-BAM
# engine, `device` its Python window walk.
PILEUP_ENV = "BISCUIT_TPU_TORCH_PILEUP"
PILEUP_ENGINES = ("device", "native", "mesh")
PILEUP_DEFAULT = "device"
# the raw per-chromosome accumulators of _meth_average.tsv as JSON, for the
# sharded pileup driver's merge (biscuit_tpu_torch/tools/shard_pileup.py)
MA_RAW_ENV = "BISCUIT_TPU_TORCH_MA_RAW"


def main_pileup(argv):
    """biscuit pileup port (src/pileup.c:1014-1225): windowed joint
    methylation + SNP calling to VCF. Counterpart of
    biscuit_tpu.cli.main_pileup, on the engine named by
    BISCUIT_TPU_TORCH_PILEUP (PILEUP_ENGINES)."""
    from .device import resolve
    from .io.sambam import AlignmentFile, _is_bam
    from .pileup.common import RefCache, NCONTXTS
    from .pileup.engine import (STAGES, PileupConf, meth_average_table,
                                pileup_window, run_windows, vcf_header)

    conf = PileupConf()
    reg = None
    tum = nor = None
    outfn = None
    statsfn = None
    opts, args = getopt.getopt(argv, "o:w:g:@:5:3:b:s:E:M:x:C:P:Q:t:n:m:a:l:T:I:SNrcdupv:h")
    for o, a in opts:
        c = o[1]
        if c == "g": reg = a
        elif c == "@": conf.bt.n_threads = int(a)
        elif c == "s": conf.bt.step = int(a)
        elif c == "N": conf.comm.is_nome = 1
        elif c == "S": conf.somatic = 1
        elif c == "T": tum = a
        elif c == "I": nor = a
        elif c == "o": outfn = a
        elif c == "w": statsfn = a
        elif c == "v": conf.comm.verbose = int(a)
        elif c == "b": conf.filt.min_base_qual = int(a)
        elif c == "m": conf.filt.min_mapq = int(a)
        elif c == "a": conf.filt.min_score = int(a)
        elif c == "t": conf.filt.max_retention = int(a)
        elif c == "l": conf.filt.min_read_len = int(a)
        elif c == "5": conf.filt.min_dist_end_5p = int(a)
        elif c == "3": conf.filt.min_dist_end_3p = int(a)
        elif c == "r": conf.ambi_redist = 0
        elif c == "c": conf.filt.filter_secondary = 0
        elif c == "d": conf.filt.filter_doublecnt = 0
        elif c == "u": conf.filt.filter_duplicate = 0
        elif c == "p": conf.filt.filter_ppair = 0
        elif c == "n": conf.filt.max_nm = int(a)
        elif c == "E": conf.error = float(a)
        elif c == "M": conf.mu = float(a)
        elif c == "x": conf.mu_somatic = float(a)
        elif c == "C": conf.contam = float(a)
        elif c == "P": conf.prior1 = float(a)
        elif c == "Q": conf.prior2 = float(a)
        elif c == "h":
            d = PileupConf()
            print(f"""
Usage: biscuit_tpu pileup [options] <ref.fa> <in1.bam> [in2.bam ...]
Som. Mode Usage: biscuit_tpu pileup [options] <-S -T tum.bam -I norm.bam> <ref.fa>

Options:
    -g STR      Region to process (whole BAM if absent)
    -@ INT      Number of window workers [{d.bt.n_threads}], a fork pool;
                under the device engine on a CUDA device the windows run in
                order in the one process that owns the card, whatever INT
                is (the output is the same);
                BISCUIT_TPU_TORCH_PILEUP=native forks them on any device
    -s INT      Window dispatch step [{d.bt.step}]
    -N          NOMe-seq mode [off]
    -S          Somatic mode (requires -T and -I) [off]
    -T STR      Somatic mode: tumor BAM
    -I STR      Somatic mode: normal BAM

Output options:
    -o STR      Output file [stdout]
    -w STR      Pileup statistics output prefix [same as -o]
    -v INT      Verbosity (>0 adds DIAGNOSE blocks) [0]

Filter options:
    -b INT      Minimum base quality [{d.filt.min_base_qual}]
    -m INT      Minimum mapping quality [{d.filt.min_mapq}]
    -a INT      Minimum alignment score (AS tag) [{d.filt.min_score}]
    -t INT      Maximum cytosine retention per read [{d.filt.max_retention}]
    -l INT      Minimum read length [{d.filt.min_read_len}]
    -5 INT      Minimum distance to the 5' read end [{d.filt.min_dist_end_5p}]
    -3 INT      Minimum distance to the 3' read end [{d.filt.min_dist_end_3p}]
    -r          Do NOT redistribute ambiguous (Y/R) calls in genotyping
    -c          Do NOT filter secondary mappings
    -d          Double-count cytosines in overlapping mates
    -u          Do NOT filter duplicate-flagged reads
    -p          Do NOT filter improper pairs
    -n INT      Maximum NM tag [{d.filt.max_nm}]

Genotyping options:
    -E FLOAT    Error rate [{d.error:.3f}]
    -M FLOAT    Mutation rate [{d.mu:.3f}]
    -x FLOAT    Somatic mutation rate [{d.mu_somatic:.3f}]
    -C FLOAT    Contamination rate [{d.contam:.3f}]
    -P FLOAT    Prior for a heterozygous variant [{d.prior1:.3f}]
    -Q FLOAT    Prior for a homozygous variant [{d.prior2:.3f}]
    -h          This help
""", file=sys.stderr)
            return 1

    if conf.somatic:
        if len(args) < 1:
            print("Reference input is missing", file=sys.stderr)
            return 1
        if not tum or not nor:
            print("Somatic mode requires -T and -I", file=sys.stderr)
            return 1
        reffn = args[0]
        in_fns = [tum, nor]
    else:
        if len(args) < 2:
            print("Reference or bam input is missing", file=sys.stderr)
            return 1
        if tum or nor:
            print("-T/-I require -S", file=sys.stderr)
            return 1
        reffn = args[0]
        in_fns = args[1:]

    engine = os.environ.get(PILEUP_ENV, PILEUP_DEFAULT)
    if engine not in PILEUP_ENGINES:
        print(f"[E::main_pileup] unknown engine '{engine}' in {PILEUP_ENV} "
              f"(one of {', '.join(PILEUP_ENGINES)})", file=sys.stderr)
        return 1
    # the C++ engine makes no CUDA context: None is its device
    device = resolve() if engine != "native" else None
    writes = True  # only rank 0 of a mesh writes
    if engine == "mesh":
        from .parallel.mesh import init_from_env, make_mesh
        world, rank, backend, device = init_from_env(device)
        print(f"[main_pileup] mesh: rank {rank} of {world}, backend "
              f"{backend or 'none (one rank)'}, device {device}",
              file=sys.stderr)
        device = make_mesh(world, device)
        writes = rank == 0
    t_open = time.perf_counter()
    # raw-BAM fast path: the C++ engine, and the device engine's C++ walk
    # (pileup/walk.py), parse records straight from the decompressed blob
    # (fork workers share it copy-on-write)
    if (engine in ("native", "device") and not conf.comm.verbose
            and all(_is_bam(fn) for fn in in_fns)):
        from .pileup.native import raw_bam_open
        # with a usable .bai, stream each window's blocks (bounded memory);
        # otherwise hold the decompressed blob (shared by fork workers)
        bams = [raw_bam_open(fn) for fn in in_fns]
    else:
        bams = [AlignmentFile(fn) for fn in in_fns]
    hdr = bams[0].header
    # sorted targets (alphabetic, like the reference qsort by name)
    targets = sorted(range(len(hdr.names)),
                     key=lambda tid: hdr.names[tid])  # list of tids in name order
    target_pairs = [(hdr.names[t], hdr.lengths[t]) for t in targets]

    if not writes:
        out = open(os.devnull, "w")
    else:
        out = open(outfn, "w") if outfn else sys.stdout
    out.write(vcf_header(reffn, target_pairs, ["pileup"] + argv, conf, in_fns))

    rs = RefCache(reffn)
    STAGES["open"] += time.perf_counter() - t_open
    n_bams = len(in_fns)
    # per-sample, per-tid context stats
    betasum = [{} for _ in range(n_bams)]
    cnts = [{} for _ in range(n_bams)]

    def window_stats(tid):
        bs = [betasum[sid].setdefault(tid, [0.0] * NCONTXTS) for sid in range(n_bams)]
        cs = [cnts[sid].setdefault(tid, [0] * NCONTXTS) for sid in range(n_bams)]
        return bs, cs

    step = conf.bt.step
    windows = []  # (tid, name, wbeg, wend)
    if reg:
        if ":" in reg:
            name, rng = reg.split(":", 1)
            beg, end = rng.replace(",", "").split("-")
            beg, end = int(beg), int(end)
        else:
            name, beg, end = reg, 0, 1 << 29
        tid = hdr.name2tid(name)
        if tid < 0:
            print(f"[main_pileup] unknown region {reg}", file=sys.stderr)
            return 1
        beg += 1
        beg = max(beg, 1)
        end = min(end, hdr.lengths[tid])
        wbeg = beg
        while wbeg < end:
            windows.append((tid, hdr.names[tid], wbeg, min(wbeg + step, end)))
            wbeg += step
    else:
        for t in targets:
            tlen = hdr.lengths[t]
            wbeg = 1
            while wbeg < tlen:
                windows.append((t, hdr.names[t], wbeg, min(wbeg + step, tlen)))
                wbeg += step

    if conf.bt.n_threads > 1 and len(windows) > 1:
        n_procs = min(conf.bt.n_threads, len(windows))
        for (tid, _nm, _b, _e), text, wbs, wcs in run_windows(
                bams, rs, conf, windows, n_procs, device):
            out.write(text)
            bs, cs = window_stats(tid)
            for sid in range(n_bams):
                for k in range(NCONTXTS):
                    bs[sid][k] += wbs[sid][k]
                    cs[sid][k] += wcs[sid][k]
    else:
        for tid, name, wbeg, wend in windows:
            bs, cs = window_stats(tid)
            out.write(pileup_window(bams, rs, conf, tid, name, wbeg, wend,
                                    bs, cs, device))

    if out is not sys.stdout:
        out.close()
    if not statsfn and outfn:
        statsfn = outfn
    if statsfn and writes:
        with open(statsfn + "_meth_average.tsv", "w") as f:
            if conf.comm.is_nome:
                f.write("sample\tchrm\tHCGn\tHCGb\tHCHGn\tHCHGb\tHCHHn\tHCHHb\tHCHn\tHCHb\tGCn\tGCb\n")
            else:
                f.write("sample\tchrm\tCGn\tCGb\tCHGn\tCHGb\tCHHn\tCHHb\tCHn\tCHb\n")
            for sid, fn in enumerate(in_fns):
                # the reference prints the raw bam path as the sample column
                # (pileup.c:218 passes c->bam_fns[sid])
                sample = fn
                # reproduce the reference's write_func/print_meth_average1
                # indexing: stats are accumulated by ORIGINAL tid but rows are
                # emitted in sorted-target order with data taken at index k
                # and name at sorted_targets[sorted_targets[k].tid]
                # (pileup.c:128-138); identical whenever name order == tid
                # order
                by_row_beta = {}
                by_row_cnt = {}
                for k, t in enumerate(targets):
                    by_row_beta[k] = betasum[sid].get(k, [0.0] * NCONTXTS)
                    by_row_cnt[k] = cnts[sid].get(k, [0] * NCONTXTS)
                names = [(hdr.names[targets[t]], hdr.lengths[t])
                         for t in targets]
                for line in meth_average_table(conf, sample, names,
                                               by_row_beta, by_row_cnt):
                    f.write(line)
    raw_fn = os.environ.get(MA_RAW_ENV)
    if raw_fn and writes:
        # machine-readable raw accumulators for multi-host merging
        # (tools/shard_pileup.py recomputes WholeGenome from exact sums)
        import json as _json
        dump = {}
        for sid, fn in enumerate(in_fns):
            per = {}
            for tid in range(len(hdr.names)):   # accumulators key = true tid
                per[hdr.names[tid]] = {
                    "betasum": betasum[sid].get(tid, [0.0] * NCONTXTS),
                    "cnt": cnts[sid].get(tid, [0] * NCONTXTS),
                }
            dump[fn] = per
        with open(raw_fn, "w") as f:
            _json.dump({"is_nome": int(conf.comm.is_nome), "stats": dump}, f)
    report_launches("main_pileup")
    if engine == "mesh" and device.size() > 1:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


def main_sort(argv):
    """Utility (not in the reference, which delegates to samtools): sort a
    SAM/BAM by coordinate and write BAM (or SAM with -O sam). Inputs larger
    than the -m record budget spill to sorted temp runs merged with a k-way
    heap (samtools-style external sort)."""
    from .io.sambam import (AlignmentFile, _is_bam, stream_bam_records,
                            write_bam, write_sam)
    out = None
    fmt = "bam"
    max_mem_records = 2_000_000
    opts, args = getopt.getopt(argv, "o:O:m:h")
    for o, a in opts:
        if o == "-o":
            out = a
        elif o == "-O":
            fmt = a
        elif o == "-m":
            max_mem_records = int(a)
    if not args or not out:
        print("Usage: biscuit_tpu sort -o out.bam [-O bam|sam]"
              " [-m max-records-in-memory] <in.sam|in.bam>", file=sys.stderr)
        return 1

    key = lambda r: (r.tid if r.tid >= 0 else 1 << 30, r.pos)
    if _is_bam(args[0]):
        hdr = None
        it = stream_bam_records(args[0])
        # need the header separately
        from .io.sambam import _parse_bam_header_streaming
        hdr = _parse_bam_header_streaming(args[0])
    else:
        af = AlignmentFile(args[0])
        hdr = af.header
        it = iter(af)

    import heapq
    import tempfile

    runs = []          # paths of spilled sorted runs
    chunk = []
    tmpdir = None
    for r in it:
        chunk.append(r)
        if len(chunk) >= max_mem_records:
            chunk.sort(key=key)
            if tmpdir is None:
                tmpdir = tempfile.mkdtemp(prefix="btsort")
            runp = os.path.join(tmpdir, f"run{len(runs)}.bam")
            write_bam(runp, hdr, chunk)
            runs.append(runp)
            chunk = []
    chunk.sort(key=key)

    if not any(l.startswith("@HD") for l in hdr.lines):
        hdr.lines.insert(0, "@HD\tVN:1.6\tSO:coordinate")

    if not runs:
        recs = chunk
    else:
        streams = [stream_bam_records(p) for p in runs] + [iter(chunk)]
        recs = heapq.merge(*streams, key=key)
    if fmt == "sam":
        write_sam(out, hdr, recs)
    else:
        write_bam(out, hdr, recs)
    if runs:
        import shutil
        shutil.rmtree(tmpdir, ignore_errors=True)
    return 0


def main_bamindex(argv):
    """Utility (reference workflows use `samtools index`): build a
    samtools-compatible .bai index for a coordinate-sorted BAM, enabling
    streamed region queries (io/bai.py)."""
    opts, args = getopt.getopt(argv, "h")
    if not args:
        print("Usage: biscuit_tpu bamindex <in.bam>", file=sys.stderr)
        return 1
    from .io.bai import build_bai
    build_bai(args[0]).write(args[0] + ".bai")
    return 0


def _sub(name):
    def run(argv):
        import importlib
        mod = importlib.import_module(f".subcmds.{name}",
                                      package="biscuit_tpu_torch")
        return mod.main(argv)
    return run


def main_epiread(argv):
    """epiread (subcmds/epiread.py), which reads pileup's switch:
    BISCUIT_TPU_TORCH_PILEUP=native (its default) runs the C++ raw-BAM
    window engine on BAM input, `device` the Python window walk (epiread
    has no kernel); any other value exits 1, as pileup does."""
    engine = os.environ.get(PILEUP_ENV, "native")
    if engine not in PILEUP_ENGINES:
        print(f"[E::main_epiread] unknown engine '{engine}' in {PILEUP_ENV} "
              f"(one of {', '.join(PILEUP_ENGINES)})", file=sys.stderr)
        return 1
    return _sub("epiread")(argv)


SUBCOMMANDS = {
    "index": main_index,
    "align": main_align,
    "pileup": main_pileup,
    "sort": main_sort,
    "bamindex": main_bamindex,
    "vcf2bed": _sub("vcf2bed"),
    "mergecg": _sub("mergecg"),
    "epiread": main_epiread,
    "asm": _sub("asm"),
    "bsstrand": _sub("bsstrand"),
    "bsconv": _sub("bsconv"),
    "cinread": _sub("cinread"),
    "qc": _sub("qc"),
    "bc": _sub("bc"),
    "rectangle": _sub("rectangle"),
    "tview": _sub("tview"),
}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print(f"""
Program: biscuit_tpu_torch (the PyTorch + CUDA port of biscuit_tpu)
Version: {__version__} (behavioral parity target: biscuit {REFERENCE_VERSION})

Usage: python -m biscuit_tpu_torch.cli <command> [options]

Command:
 -- Read mapping
    index        Index reference genome sequences in the FASTA format
    align        Align bisulfite-treated short reads (adapted BWA-MEM)

 -- BAM operation
    tview        Text alignment viewer with bisulfite coloring
    bsstrand     Validate/correct the bisulfite strand label (YD tag)
    bsconv       Summarize/filter reads by bisulfite conversion (ZN tag)
    cinread      Print cytosine-read pairs in long form

 -- Base summary
    pileup       Pileup cytosines and mutations to VCF
    vcf2bed      Convert VCF to BED tracks
    mergecg      Merge the C and G of a CpG

 -- Epireads
    epiread      Convert BAM to the epiBED format
    rectangle    Convert old epiread format to a rectangular matrix
    asm          Test allele-specific methylation

 -- Other
    bc           Extract barcodes/UMIs from FASTQ
    sort         Coordinate-sort SAM/BAM
    bamindex     Write a .bai index for a sorted BAM
    version      Print the version
""", file=sys.stderr)
        return 1
    if argv[0] == "version":
        print(f"biscuit_tpu_torch {__version__} "
              f"(reference parity {REFERENCE_VERSION})")
        return 0
    cmd = SUBCOMMANDS.get(argv[0])
    if cmd is None:
        print(f"Unknown subcommand: {argv[0]}", file=sys.stderr)
        return 1
    try:
        ret = cmd(argv[1:])
        if ret in (0, None):
            # end-of-run summary like the reference main (src/main.c:152-157),
            # anchored at PROCESS start (covers interpreter + torch imports)
            t = os.times()
            try:
                with open("/proc/self/stat") as f:
                    start_ticks = int(f.read().rsplit(") ", 1)[1].split()[19])
                with open("/proc/uptime") as f:
                    up = float(f.read().split()[0])
                real = up - start_ticks / os.sysconf("SC_CLK_TCK")
            except OSError:
                real = t.elapsed
            print(f"[main] Version: {__version__}", file=sys.stderr)
            print("[main] CMD: biscuit_tpu_torch " + " ".join(argv),
                  file=sys.stderr)
            print(f"[main] Real time: {real:.3f} sec; "
                  f"CPU: {t.user + t.system + t.children_user + t.children_system:.3f} sec",
                  file=sys.stderr)
        return ret
    except BrokenPipeError:
        # downstream consumer (e.g. `| head`) closed the pipe: exit quietly
        # like the reference's EPIPE handling
        try:
            sys.stdout.close()
        except Exception:
            pass
        os._exit(1)


if __name__ == "__main__":
    sys.exit(main())
