"""FASTQ input with the reference's read-structure semantics
(lib/aln/bwa.c:749-850: bis_bseq_read / bis_kseq2bseq1 /
trim_readno, bseq_classify in bwamem).

Copy of biscuit_tpu/io/fastq.py: the code is the source's, so that the port
imports nothing of the JAX package; tests/test_torch_engine.py holds the
copy to its source.
"""
import gzip
from dataclasses import dataclass, field
from typing import Iterator, List, Optional

import numpy as np

from ..index.fasta import NT4


@dataclass
class BSeq:
    name: str
    seq: np.ndarray           # nt4 codes (post-clipping view)
    l_seq: int
    qual: Optional[str] = None
    comment: Optional[str] = None
    barcode: Optional[str] = None
    umi: Optional[str] = None
    seq0: Optional[np.ndarray] = None  # original full codes
    l_seq0: int = 0
    clip5: int = 0
    clip3: int = 0
    l_adaptor: int = 0
    sam: Optional[str] = None
    id: int = 0
    bisseq: dict = field(default_factory=dict)


def trim_readno(name: str) -> str:
    """bwa.c trim_readno: strip trailing /1 or /2."""
    if len(name) > 2 and name[-2] == "/" and name[-1] in "12":
        return name[:-2]
    return name


def _open_source(path: str):
    """kopen-equivalent input flexibility (lib/aln/kopen.c): plain files,
    '-' for stdin, 'cmd |' shell pipes, and http://... URLs all work as
    FASTQ sources. Compression is sniffed from the gzip magic (piped data
    has no extension), so .gz handling works on every source kind."""
    import io
    import subprocess
    import sys

    if path == "-":
        raw = sys.stdin.buffer
    elif path.endswith("|"):
        proc = subprocess.Popen(path[:-1], shell=True,
                                stdout=subprocess.PIPE)
        raw = proc.stdout
    elif path.startswith(("http://", "https://", "ftp://")):
        import urllib.request
        raw = urllib.request.urlopen(path)
    else:
        raw = open(path, "rb")
    buf = io.BufferedReader(raw) if not isinstance(raw, io.BufferedReader) \
        else raw
    if buf.peek(2)[:2] == b"\x1f\x8b":
        return gzip.open(buf, "rb")
    return buf


def _fastq_records(path: str):
    """Yield (name, comment, seq_bytes, qual_str|None) per record.

    Bulk reader: splits 8 MB chunks on newlines in one C pass instead of
    per-line readline calls (the reference's kseq.h buffered reader plays
    the same role, lib/aln/kseq.h). Sequences stay as bytes; read_batch
    nt4-converts a whole batch in one vectorized pass.
    """
    with _open_source(path) as f:
        tail = b""
        while True:
            chunk = f.read(1 << 23)
            if not chunk:
                break
            data = tail + chunk if tail else chunk
            lines = data.split(b"\n")
            last = lines.pop()  # partial line (or b"" on a newline boundary)
            nfull = (len(lines) // 4) * 4
            if nfull != len(lines):
                rem = lines[nfull:]
                rem.append(last)
                tail = b"\n".join(rem)
                del lines[nfull:]
            else:
                tail = last
            for i in range(0, nfull, 4):
                hdr = lines[i]
                parts = hdr[1:].split(None, 1)
                name = parts[0].decode() if parts else ""
                comment = parts[1].decode() if len(parts) > 1 else None
                qual = lines[i + 3]
                yield name, comment, lines[i + 1], \
                    (qual.decode() if qual else None)
        # file may end without a trailing newline: flush any complete record
        if tail:
            lines = tail.split(b"\n")
            for i in range(0, (len(lines) // 4) * 4, 4):
                hdr = lines[i]
                parts = hdr[1:].split(None, 1)
                name = parts[0].decode() if parts else ""
                comment = parts[1].decode() if len(parts) > 1 else None
                qual = lines[i + 3]
                yield name, comment, lines[i + 1], \
                    (qual.decode() if qual else None)


def make_bseq(name: str, comment: Optional[str], seq, qual: Optional[str],
              has_bc: bool = False) -> BSeq:
    raw = seq if isinstance(seq, (bytes, bytearray)) else seq.encode()
    codes = NT4[np.frombuffer(raw, dtype=np.uint8)].copy()
    barcode = umi = None
    if has_bc:
        toks = name.split("_")
        if len(toks) >= 3:
            barcode, umi = toks[-2], toks[-1]
    s = BSeq(name=name, seq=codes, l_seq=len(codes), qual=qual, comment=comment,
             barcode=barcode, umi=umi, seq0=codes, l_seq0=len(codes))
    return s


def read_batch(it1, it2, chunk_size: int, has_bc: bool = False) -> List[BSeq]:
    """bis_bseq_read: read up to chunk_size bp (interleaving mates).

    Collects raw records first, then nt4-converts the whole batch in one
    vectorized pass; each read's codes are disjoint views of the shared
    buffer, so in-place edits stay read-local (seq0 aliases seq exactly as
    the per-read path did)."""
    raw = []
    size = 0
    while True:
        try:
            rec1 = next(it1)
        except StopIteration:
            break
        if it2 is not None:
            try:
                rec2 = next(it2)
            except StopIteration:
                import sys
                print("[W::bseq_read] the 2nd file has fewer sequences.", file=sys.stderr)
                break
        raw.append(rec1)
        size += len(rec1[2])
        if it2 is not None:
            raw.append(rec2)
            size += len(rec2[2])
        if size >= chunk_size and len(raw) % 2 == 0:
            break
    if not raw:
        return []
    seqb = [r[2] if isinstance(r[2], (bytes, bytearray)) else r[2].encode()
            for r in raw]
    codes = NT4[np.frombuffer(b"".join(seqb), dtype=np.uint8)]
    seqs: List[BSeq] = []
    pos = 0
    for i, (name, comment, _s, qual) in enumerate(raw):
        ln = len(seqb[i])
        v = codes[pos:pos + ln]
        pos += ln
        name = trim_readno(name)
        barcode = umi = None
        if has_bc:
            toks = name.split("_")
            if len(toks) >= 3:
                barcode, umi = toks[-2], toks[-1]
        seqs.append(BSeq(name=name, seq=v, l_seq=ln, qual=qual,
                         comment=comment, barcode=barcode, umi=umi,
                         seq0=v, l_seq0=ln, id=i))
    return seqs


def fastq_iter(path: str):
    return _fastq_records(path)
