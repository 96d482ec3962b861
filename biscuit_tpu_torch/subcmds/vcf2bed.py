"""biscuit vcf2bed port (src/vcf2bed.c): BISCUIT VCF ->
beta/coverage bed tracks or SNP bed.

The context-track mode (the GB-scale path: one VCF row per genomic C) runs
through the native C++ chunk filter (native/streams_native.cpp) by default;
BISCUIT_TPU_TORCH_STREAMS=python keeps the pure-Python line walk. Both are
byte-diffed against the compiled reference (tests/test_downstream_oracle.py).

Copy of biscuit_tpu/subcmds/vcf2bed.py: the switch is the port's own
(BISCUIT_TPU_TORCH_STREAMS where the source reads BISCUIT_TPU_STREAMS);
the rest is the source's code, which tests/test_torch_engine.py holds
the copy to.
"""
import getopt
import gzip
import os
import sys

from ..io.vcf import VcfFile


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _record_beta_cov(rec, idx):
    bt = rec.fmt_get("BT", idx)
    cv = rec.fmt_get("CV", idx)
    n = len(idx)
    betas = [-1.0] * n
    covs = [0] * n
    if bt is not None:
        for i, v in enumerate(bt):
            betas[i] = float(v) if (_is_number(v) and v != ".") else -1.0
    if cv is not None:
        for i, v in enumerate(cv):
            covs[i] = int(v) if (_is_number(v) and v != ".") else 0
    return betas, covs


def vcf2bed_ctxt(vcf: VcfFile, mincov: int, showctxt: bool, showmu: bool,
                 cx_target: str, out) -> None:
    idx = vcf.target_idx
    # substring pre-filter: for a specific context target, reject lines
    # cheaply before the full field parse (most records are other contexts)
    needle = None if cx_target in ("C", "CH") else f"CX={cx_target}"
    for line in vcf.raw_body():
        if "CX=" not in line:
            continue
        if needle is not None and needle not in line:
            continue
        rec = vcf.parse_line(line)
        cx = rec.info_get("CX")
        if cx is None:
            continue
        ref = rec.ref[0]
        if cx_target == "C":
            if ref not in ("C", "G"):
                continue
        elif cx_target == "CH":
            if cx not in ("CHH", "CHG"):
                continue
        elif cx != cx_target:
            continue
        if rec.tid < 0:
            continue
        betas, covs = _record_beta_cov(rec, idx)
        if not any(c >= mincov for c in covs):
            continue
        n5 = rec.info_get("N5") or "NNNNN"
        if len(n5) != 5:
            n5 = "NNNNN"
        parts = [f"{rec.chrom}\t{rec.pos - 1}\t{rec.pos}"]
        if showctxt:
            parts.append(f"\t{ref}\t{cx}\t{n5[2:4]}\t{n5[:5]}")
        for b, c in zip(betas, covs):
            if showmu:
                m = int(round(c * b)) if b >= 0 else 0
                if b < 0:
                    parts.append("\t.")
                else:
                    parts.append(f"\t{int(round(b * 100))}")
                parts.append(f"\t{m}\t{c - m}")
            else:
                if b < 0:
                    parts.append("\t.")
                else:
                    parts.append("\t%1.3f" % b)
                parts.append(f"\t{c}")
        out.write("".join(parts) + "\n")


def vcf2bed_ctxt_native(path: str, target_idx, mincov: int, showctxt: bool,
                        showmu: bool, cx_target: str, out) -> None:
    """Chunked C++ filter: Python decodes (b)gzip and streams 4 MB slabs of
    complete lines; the parse/filter/format runs in streams_native.cpp."""
    import ctypes as C
    import numpy as np
    from .. import native

    L = native.lib()  # argtypes/restype centralized in native._declare

    sidx = np.asarray(target_idx, np.int32)
    ob = out.buffer if hasattr(out, "buffer") else out
    opener = gzip.open if path.endswith(".gz") else open
    olen = C.c_int64(0)
    with opener(path, "rb") as f:
        rem = b""
        while True:
            chunk = f.read(4 << 20)
            if not chunk:
                break
            buf = rem + chunk
            cut = buf.rfind(b"\n") + 1
            rem = buf[cut:]
            buf = buf[:cut]
            if not buf:
                continue
            p = L.bt_vcf2bed_ctxt(buf, len(buf), mincov, int(showctxt),
                                  int(showmu), cx_target.encode(), sidx,
                                  len(sidx), C.byref(olen))
            if olen.value:
                ob.write(C.string_at(p, olen.value))
            L.bt_stream_free(p)
        if rem:
            p = L.bt_vcf2bed_ctxt(rem, len(rem), mincov, int(showctxt),
                                  int(showmu), cx_target.encode(), sidx,
                                  len(sidx), C.byref(olen))
            if olen.value:
                ob.write(C.string_at(p, olen.value))
            L.bt_stream_free(p)
    ob.flush()


def vcf2bed_snp(vcf: VcfFile, mincov: int, out) -> None:
    idx = vcf.target_idx
    for rec in vcf:
        if rec.alt == ".":
            continue
        gt = rec.fmt_get("GT", idx)
        sp = rec.fmt_get("SP", idx)
        ac = rec.fmt_get("AC", idx)
        af = rec.fmt_get("AF1", idx)
        if gt is None or sp is None or ac is None or af is None:
            raise SystemExit(f"Malformed VCF file (unmatched no. records) at {rec.chrom}:{rec.pos}")
        if rec.tid < 0:
            continue
        highest_cov = 0
        highest_af = 0.0
        for i in range(len(idx)):
            try:
                cov = int(ac[i])
            except ValueError:
                cov = 0
            highest_cov = max(highest_cov, cov)
            try:
                a = float(af[i])
            except ValueError:
                a = 0.0
            highest_af = max(highest_af, a)
        if highest_cov < mincov:
            continue
        if highest_af <= 0.0:
            continue
        parts = [f"{rec.chrom}\t{rec.pos - 1}\t{rec.pos}\t{rec.ref}\t{rec.alt}"]
        for i in range(len(idx)):
            parts.append(f"\t{gt[i]}\t{sp[i]}\t{ac[i]}\t{af[i]}")
        out.write("".join(parts) + "\n")


def main(argv):
    mincov = 1
    showctxt = False
    showmu = False
    target = "CG"
    samples = None
    opts, args = getopt.getopt(argv, "t:k:s:ech")
    for o, a in opts:
        if o == "-k":
            mincov = int(a)
        elif o == "-t":
            target = a
        elif o == "-s":
            samples = a
        elif o == "-e":
            showctxt = True
        elif o == "-c":
            showmu = True
        elif o == "-h":
            print("Usage: biscuit_tpu vcf2bed [options] <in.vcf>", file=sys.stderr)
            return 1
    if not args:
        print("Please provide input vcf.", file=sys.stderr)
        return 1
    vcf = VcfFile(args[0])
    vcf.select_samples(samples or "FIRST")
    target = target.upper()
    if target not in ("CG", "CH", "C", "HCG", "GCH", "SNP"):
        print(f"Invalid option for -t: {target}", file=sys.stderr)
        return 1
    if target == "SNP":
        vcf2bed_snp(vcf, mincov, sys.stdout)
    elif os.environ.get("BISCUIT_TPU_TORCH_STREAMS", "native") == "python":
        vcf2bed_ctxt(vcf, mincov, showctxt, showmu, target, sys.stdout)
    else:
        vcf2bed_ctxt_native(args[0], vcf.target_idx, mincov, showctxt,
                            showmu, target, sys.stdout)
    vcf.close()
    return 0
