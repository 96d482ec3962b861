#!/usr/bin/env python3
"""Multi-host data-parallel alignment driver over the port.

The single-process aligner already data-parallelizes a batch across one
host's cores (and a chip's lanes on the device engine). This driver is the
multi-HOST layer of SURVEY.md §2d: workers stream the SAME fastq with a
record stride (each owns records k, k+n, ...), one `biscuit_tpu_torch
align` process per shard (each host/process loads or mmaps the same index),
and the SAM shards are interleaved back record-by-record so the output
order equals the single-process order.

The ordered merge STREAMS concurrently with the workers (the reference's
ordered-shelf protocol, src/bisc_utils.c:240-271, lifted to processes): a
merger tails every worker's growing output file and emits the next
round-robin qname group the moment it is complete, so by the time workers
exit only the last groups remain.

Streaming FASTQ sources the align CLI accepts (stdin '-', 'cmd |' shell
pipes, http[s]/ftp URLs) are spooled once to a temp file first — n
striding workers each need an independent pass over the same bytes.

Copy of tools/shard_align.py over the port: its workers run
`python -m biscuit_tpu_torch.cli align` (the engine of
BISCUIT_TPU_TORCH_ENGINE, on the device of BISCUIT_TPU_TORCH_DEVICE) under
BISCUIT_TPU_TORCH_FASTQ_STRIDE and BISCUIT_TPU_TORCH_PES_EXCHANGE, and
`_spool` reads the source with the port's reader. tests/test_torch_engine.py
holds the copy to its source.

Usage (from the repository's root):
    python -m biscuit_tpu_torch.tools.shard_align -n 4 [-p] [align options...] ref.fa r1.fq [r2.fq] > out.sam
"""
import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time


def _is_streaming_src(a: str) -> bool:
    """kopen-style non-file FASTQ sources (io/fastq._open_source)."""
    return a == "-" or a.endswith("|") or \
        a.startswith(("http://", "https://", "ftp://"))


def _spool(src: str, dst: str) -> str:
    """Copy a streaming source's raw bytes to a file (gzip bytes stay
    gzip; the workers sniff the magic exactly as they would the source)."""
    from biscuit_tpu_torch.io.fastq import _open_source
    f = _open_source(src)
    # _open_source transparently gunzips; spool the DECODED stream (plain
    # fastq) so workers see well-formed input either way
    with open(dst, "wb") as o:
        shutil.copyfileobj(f, o, 1 << 20)
    return dst


class ShardTail:
    """Incremental reader over one worker's growing SAM file: yields
    complete qname GROUPS (a read's records — mates, supplementaries —
    share the qname and are written contiguously by the worker)."""

    def __init__(self, path: str, proc: subprocess.Popen):
        self.f = open(path)
        self.proc = proc
        self.lines = []          # complete lines, headers already dropped
        self.head = 0            # consume cursor (del-front on a list is
        self.header = []         # O(remaining) per group = quadratic)
        self.partial = ""
        self.eof = False
        self.in_header = True

    def _pump(self) -> bool:
        data = self.f.read(1 << 20)
        if not data:
            if self.proc.poll() is not None:
                data = self.f.read()     # final drain after exit
                if not data:
                    self.eof = True
                    return False
            else:
                return False
        parts = (self.partial + data).split("\n")
        self.partial = parts.pop()
        for l in parts:
            if self.in_header:
                if l.startswith("@"):
                    self.header.append(l)
                    continue
                self.in_header = False
            self.lines.append(l)
        return True

    def next_group(self):
        """Block until one full qname group is available; None when the
        worker exited and everything was consumed."""
        while True:
            lines, h = self.lines, self.head
            if h < len(lines):
                q0t = lines[h].split("\t", 1)[0] + "\t"
                k = h + 1
                # followers share the qname prefix — startswith avoids a
                # split allocation per record
                while k < len(lines) and lines[k].startswith(q0t):
                    k += 1
                # the group is complete if a different qname follows, or
                # nothing can follow (worker done, buffers drained)
                if k < len(lines) or (self.eof and not self.partial):
                    g = lines[h:k]
                    self.head = k
                    if self.head > 8192:   # reclaim the consumed prefix
                        del lines[:self.head]
                        self.head = 0
                    return g
            elif self.eof:
                return None
            if not self._pump():
                if not self.eof:
                    time.sleep(0.02)

    def wait_header(self):
        while self.in_header and not self.eof:
            if not self._pump():
                time.sleep(0.02)
        return self.header


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=os.cpu_count() or 2,
                    help="number of worker processes (one per 'host')")
    ap.add_argument("rest", nargs=argparse.REMAINDER,
                    help="align options + ref.fa + fastq(s)")
    args, unknown = ap.parse_known_args()
    rest = unknown + args.rest  # pass-through align flags
    # split trailing positionals (ref.fa + 1-2 fastqs) from pass-through
    # flags: a bare flag VALUE (e.g. the "1" of "-@ 1") must not count as
    # a positional, so positionals are the TRAILING args that either exist
    # on disk or are kopen streaming sources ('-', 'cmd |', URLs) — flags
    # and their values all precede them in an align command
    pos = []
    i = len(rest)
    while i > 0 and len(pos) < 3:
        a = rest[i - 1]
        if (a.startswith("-") and a != "-") or not (
                os.path.exists(a) or _is_streaming_src(a)):
            break
        pos.insert(0, a)
        i -= 1
    if len(pos) < 2:
        print("need ref.fa and at least one fastq", file=sys.stderr)
        return 1
    ref, fqs = pos[0], pos[1:]
    if not os.path.exists(ref):
        print(f"reference {ref!r} must be a regular file (its index is "
              "opened by every worker)", file=sys.stderr)
        return 1
    ref_and_flags = rest[:i] + [ref]
    pe = len(fqs) == 2

    with tempfile.TemporaryDirectory(prefix="shardaln") as td:
        # spool streaming sources once: n striding workers each need an
        # independent pass over the same records
        for j, fq in enumerate(fqs):
            if _is_streaming_src(fq):
                fqs[j] = _spool(fq, os.path.join(td, f"spool.{j}.fq"))
        procs = []
        outs = []
        exdir = os.path.join(td, "pes_exchange")
        for i in range(args.n):
            path = os.path.join(td, f"out.{i}.sam")
            of = open(path, "w")
            # every worker streams the SAME fastq, owning records
            # i, i+n, ... (BISCUIT_TPU_TORCH_FASTQ_STRIDE; with -p the cli
            # strides by PAIR groups so interleaved mates stay together)
            cmd = [sys.executable, "-m", "biscuit_tpu_torch.cli", "align",
                   *ref_and_flags, fqs[0]]
            env = dict(os.environ)
            env["BISCUIT_TPU_TORCH_FASTQ_STRIDE"] = f"{i}:{args.n}"
            if pe:
                cmd.append(fqs[1])
                # pool candidate insert sizes across ranks: every worker then
                # computes the same pes as a single-process run would
                # (reference chunk-wide semantics, bwamem.c:464-467)
                env["BISCUIT_TPU_TORCH_PES_EXCHANGE"] = f"{exdir}:{i}:{args.n}"
            if "-p" in ref_and_flags:
                env["BISCUIT_TPU_TORCH_PES_EXCHANGE"] = f"{exdir}:{i}:{args.n}"
            # BT_SHARD_WORKER_LOGS=dir keeps each worker's stderr (the
            # [M::mem_process_seqs] phase timings) for scaling analysis
            logdir = os.environ.get("BT_SHARD_WORKER_LOGS")
            errdst = (open(os.path.join(logdir, f"worker.{i}.log"), "w")
                      if logdir else subprocess.DEVNULL)
            procs.append(subprocess.Popen(cmd, stdout=of, env=env,
                                          stderr=errdst))
            if errdst is not subprocess.DEVNULL:
                errdst.close()
            outs.append((path, of))

        # STREAMING ordered merge, concurrent with the workers: header from
        # shard 0, then bodies interleaved round-robin by qname group.
        # Output is buffered in ~4 MB chunks (one write syscall each).
        # The merge yields CPU to the workers (they were spawned at normal
        # priority, so on an n-core host with n workers the merging parent
        # steals align time unless deprioritized; the merge catches up in
        # worker IO gaps and in the tail).
        try:
            os.nice(5)
        except OSError:
            pass
        tails = [ShardTail(p, procs[i]) for i, (p, _f) in enumerate(outs)]
        out = sys.stdout
        hdr = tails[0].wait_header()
        out.write("\n".join(h for h in hdr if not h.startswith("@PG")))
        out.write("\n")
        done = [False] * args.n
        i = 0
        buf = []
        buflen = 0
        while not all(done):
            w = i % args.n
            if not done[w]:
                g = tails[w].next_group()
                if g is None:
                    done[w] = True
                else:
                    buf.extend(g)
                    buflen += sum(len(x) + 1 for x in g)
                    if buflen >= (1 << 22):
                        out.write("\n".join(buf))
                        out.write("\n")
                        buf, buflen = [], 0
            i += 1
        if buf:
            out.write("\n".join(buf))
            out.write("\n")
        rcs = [p.wait() for p in procs]
        for _p, of in outs:
            of.close()
        if any(rcs):
            print(f"worker failures: {rcs}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
