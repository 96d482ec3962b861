"""biscuit mergecg port (src/mergecg.c): merge
strand-symmetric C/G beta rows of a CpG into one record (count-space merge).

Runs through the native C++ chunk engine (native/streams_native.cpp) by
default; BISCUIT_TPU_TORCH_STREAMS=python keeps the pure-Python line walk. Both
byte-diffed vs the compiled reference (tests/test_downstream_oracle.py).

Copy of biscuit_tpu/subcmds/mergecg.py: the switch is the port's own
(BISCUIT_TPU_TORCH_STREAMS where the source reads BISCUIT_TPU_STREAMS);
the rest is the source's code, which tests/test_torch_engine.py holds
the copy to.
"""
import getopt
import gzip
import os
import sys

from ..pileup.common import RefCache


class _Bed1:
    __slots__ = ("tid", "chrom", "beg", "end", "ref", "c_betas", "c_depts",
                 "g_betas", "g_depts", "nsamples")

    def __init__(self):
        self.tid = -1
        self.chrom = ""
        self.beg = 0
        self.end = 0
        self.ref = "N"
        self.nsamples = 0
        self.c_betas = []
        self.c_depts = []
        self.g_betas = []
        self.g_depts = []


def _parse_line(line, b: _Bed1, name2tid):
    f = line.rstrip("\n").split("\t")
    start = 7 if f[3] in ("C", "G") else 3
    n = (len(f) - start) // 2
    if n <= 0:
        raise SystemExit("No sample data identified.")
    b.chrom = f[0]
    b.tid = name2tid.setdefault(f[0], len(name2tid))
    b.beg = int(f[1])
    b.end = int(f[2])
    b.nsamples = n
    b.c_betas = []
    b.c_depts = []
    for i in range(n):
        v = f[start + 2 * i]
        b.c_betas.append(float(v) if v != "." else 0.0)
        b.c_depts.append(int(f[start + 1 + 2 * i]))
    b.g_betas = [0.0] * n
    b.g_depts = [0] * n


def _format_output(p: _Bed1, base_before, base_after, min_depth, show_mu, out):
    max_depth = 0
    for i in range(p.nsamples):
        max_depth = max(max_depth, p.c_depts[i] + p.g_depts[i])
    if max_depth == 0 or max_depth < min_depth:
        return
    beg, end = p.beg, p.end
    if p.ref == "C" and base_after == "G":
        end += 1
    elif p.ref == "G" and base_before == "C":
        beg -= 1
    parts = [f"{p.chrom}\t{beg}\t{end}"]
    for i in range(p.nsamples):
        cov = p.c_depts[i] + p.g_depts[i]
        if cov == 0:
            parts.append("\t.\t0\t0" if show_mu else "\t.\t0")
        else:
            c_ret = round(p.c_betas[i] * p.c_depts[i])
            g_ret = round(p.g_betas[i] * p.g_depts[i])
            m = int(c_ret + g_ret)
            if show_mu:
                parts.append(f"\t{int(round(m / cov * 100))}\t{m}\t{cov - m}")
            else:
                parts.append("\t%1.3f\t%d" % (m / cov, cov))
        if p.c_depts[i] == 0:
            parts.append("\tC:.:0")
        else:
            parts.append("\tC:%1.3f:%d" % (p.c_betas[i], p.c_depts[i]))
        if p.g_depts[i] == 0:
            parts.append(",G:.:0")
        else:
            parts.append(",G:%1.3f:%d" % (p.g_betas[i], p.g_depts[i]))
    out.write("".join(parts) + "\n")


def mergecg_native(ref_fa: str, bed_path: str, min_depth: int,
                   nome_mode: bool, show_mu: bool, out) -> int:
    """Stream the sorted bed through the stateful C++ merge engine.
    Chromosome switches surface as early returns from feed(); Python fetches
    the new sequence from RefCache and re-feeds the remaining bytes."""
    import ctypes as C
    from .. import native

    L = native.lib()  # argtypes/restype centralized in native._declare

    rc = RefCache(ref_fa)
    h = L.bt_mergecg_new(min_depth, int(nome_mode), int(show_mu))
    seq_keep = b""  # C++ borrows the sequence pointer: keep it alive
    ob = out.buffer if hasattr(out, "buffer") else out
    olen = C.c_int64(0)

    def drain():
        p = L.bt_mergecg_take_output(h, C.byref(olen))
        if olen.value:
            ob.write(C.string_at(p, olen.value))
        L.bt_stream_free(p)

    def feed(buf):
        nonlocal seq_keep
        off = 0
        while off < len(buf):
            done = L.bt_mergecg_feed(h, buf[off:], len(buf) - off)
            if L.bt_mergecg_error(h):
                drain()
                raise SystemExit(L.bt_mergecg_errmsg(h).decode())
            off += done
            if off < len(buf):
                chrom = L.bt_mergecg_need_chrom(h).decode()
                if chrom not in rc.chroms:
                    drain()
                    raise SystemExit(f"Unknown chromosome {chrom}")
                seq_keep = rc.chroms[chrom].encode()
                L.bt_mergecg_set_ref(h, chrom.encode(), seq_keep,
                                     len(seq_keep))
        drain()

    try:
        opener = gzip.open if bed_path.endswith(".gz") else open
        with opener(bed_path, "rb") as f:
            rem = b""
            while True:
                chunk = f.read(4 << 20)
                if not chunk:
                    break
                buf = rem + chunk
                cut = buf.rfind(b"\n") + 1
                rem = buf[cut:]
                feed(buf[:cut])
            if rem:
                feed(rem if rem.endswith(b"\n") else rem + b"\n")
        L.bt_mergecg_finish(h)
        drain()
        ob.flush()
    finally:
        L.bt_mergecg_free(h)
    return 0


def main(argv):
    nome_mode = False
    min_depth = 0
    show_mu = False
    opts, args = getopt.getopt(argv, "k:hNc")
    for o, a in opts:
        if o == "-N":
            nome_mode = True
        elif o == "-k":
            min_depth = int(a)
        elif o == "-c":
            show_mu = True
        elif o == "-h":
            print("Usage: biscuit_tpu mergecg [options] <ref.fa> <in.bed>", file=sys.stderr)
            return 1
    if len(args) < 2:
        print("Please supply reference file and sorted bed file.", file=sys.stderr)
        return 1
    if os.environ.get("BISCUIT_TPU_TORCH_STREAMS", "native") != "python":
        return mergecg_native(args[0], args[1], min_depth, nome_mode,
                              show_mu, sys.stdout)
    rc = RefCache(args[0])
    name2tid = {}
    out = sys.stdout
    opener = gzip.open if args[1].endswith(".gz") else open
    p = None
    p_before = p_after = "N"
    with opener(args[1], "rt") as f:
        for line in f:
            if not line.strip():
                continue
            b = _Bed1()
            _parse_line(line, b, name2tid)
            rc.fetch(b.chrom, 1, len(rc.chroms[b.chrom]))
            b.ref = rc.getbase_upcase(b.end)
            b_before = "N" if b.end - 1 < 0 else rc.getbase_upcase(b.end - 1)
            b_after = "N" if b.end == rc.end else rc.getbase_upcase(b.end + 1)
            if b.ref == "G":
                b.g_betas, b.c_betas = b.c_betas, [0.0] * b.nsamples
                b.g_depts, b.c_depts = b.c_depts, [0] * b.nsamples
            if (p is not None and b.tid == p.tid and b.beg == p.beg + 1
                    and b.end == p.end + 1 and b.ref == "G" and p.ref == "C"
                    and (not nome_mode or (p_before != "G" and b_after != "C"))):
                if p.nsamples != b.nsamples:
                    raise SystemExit(f"Missing sample at {b.chrom}:{b.beg}-{b.end}.")
                p.g_betas = b.g_betas[:]
                p.g_depts = b.g_depts[:]
                b.tid = -1  # merged
            if p is not None and p.tid >= 0:
                _format_output(p, p_before, p_after, min_depth, show_mu, out)
            p = b
            p_before, p_after = b_before, b_after
    if p is not None and p.tid >= 0:
        _format_output(p, p_before, p_after, min_depth, show_mu, out)
    return 0
