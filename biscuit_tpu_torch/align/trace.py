"""Byte-exact -v debug traces mirroring the reference aligner.

The reference prints per-read seed/chain/extension/pairing dumps to stdout
(plus a few stderr lines) when bwa_verbose >= 4 (>= 8 for pairing
internals): memchain.c:182-216,385-388,564-567,645-656,704-717,795-851,
mem_alnreg.c:81-101,216-218,295-377,438-473, mem_alnreg_format.c:56-72,
525,566-611,619,647, mem_pair.c:171-235, bwa.c:226-230,
bwamem.c:188,318,346,361,386,397,405,410, align.c:220.

Verbosity is process-global (like the reference's `bwa_verbose`); the CLI
sets it from -v. Traces are only wired through the host (Python) engine —
the CLI forces that engine when -v >= 4.

Copy of biscuit_tpu/align/trace.py. Only its imports differ: FMNumpy comes
from biscuit_tpu_torch.ops.fm and every other module from this package,
so the port imports nothing of the JAX package. tests/test_torch_engine.py holds the
copy to its source.
"""
import sys

verbose = 3


def set_verbose(v: int) -> None:
    global verbose
    verbose = v


def out(s: str) -> None:
    sys.stdout.write(s)


def err(s: str) -> None:
    sys.stderr.write(s)


def _depos(idx, rb, re):
    """bns_depos + offset removal for the region start (mem_alnreg.h:139-144):
    uses rb if on forward pac strand else re-1, mirrored around 2*l_pac."""
    l_pac = idx.l_pac
    pos = rb if rb < l_pac else re - 1
    is_rev = pos >= l_pac
    if is_rev:
        pos = (l_pac << 1) - 1 - pos
    return pos, is_rev


def region_depos(idx, reg):
    pos, _ = _depos(idx, reg.rb, reg.re)
    return pos - idx.anns[reg.rid].offset


def print_region1(idx, reg) -> None:
    """mem_print_region1 (mem_alnreg.h:146-153); idx=None omits chrom/pos."""
    if idx is not None:
        pos = region_depos(idx, reg)
        out("** %d, [%d,%d) <=> [%ld,%ld,%s,%d) sec: %d, bss: %d, parent: %d"
            % (reg.score, reg.qb, reg.qe, reg.rb, reg.re,
               idx.anns[reg.rid].name, pos, reg.secondary, reg.bss, reg.parent))
    else:
        out("** %d, [%d,%d) <=> [%ld,%ld) sec: %d, bss: %d, parent: %d"
            % (reg.score, reg.qb, reg.qe, reg.rb, reg.re,
               reg.secondary, reg.bss, reg.parent))


def print_regions(idx, regs) -> None:
    out("** %ld regions.\n" % len(regs))
    for r in regs:
        print_region1(idx, r)
        out("\n")


def _print_seed(idx, rid, s) -> None:
    l_pac = idx.l_pac
    pos = s.rbeg
    is_rev = pos >= l_pac
    if is_rev:
        pos = (l_pac << 1) - 1 - pos
        pos -= s.len - 1
    out("\t%d;%d;%d,%ld(%s:%c%ld)"
        % (s.score, s.len, s.qbeg, s.rbeg, idx.anns[rid].name,
           "-" if is_rev else "+", pos - idx.anns[rid].offset + 1))


def print_chain1(idx, c) -> None:
    """mem_print_chain1 (memchain.c:182-208)."""
    from .chain import chain_weight
    out("** CHAIN: n=%d, n_extra=%d, weight=%d"
        % (len(c.seeds), len(c.seeds_extra), chain_weight(c)))
    for s in c.seeds:
        _print_seed(idx, c.rid, s)
    out("\tEXTRA")
    for s in c.seeds_extra:
        _print_seed(idx, c.rid, s)
    out("\n")


def print_chains(idx, chains) -> None:
    for c in chains:
        print_chain1(idx, c)


def print_bases_one_per_line(arr) -> None:
    """The reference's left/right-extension ref/query dumps put a newline
    after EVERY base (memchain.c:645-655,704-714) — reproduced verbatim."""
    w = sys.stdout.write
    for b in arr:
        w("ACGTN"[int(b)])
        w("\n")


def print_bases(arr) -> None:
    w = sys.stdout.write
    for b in arr:
        w("ACGTN"[int(b)])
