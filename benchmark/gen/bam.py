"""A coordinate-sorted BAM with its .bai, written from simulated alignments.

Provenance: a frozen copy of the port's BAM writing (biscuit_tpu_torch/io/
sambam.py `_encode_bam_record` and `write_bam`, io/bgzf.py `BGZFWriter`,
io/bai.py's bins and linear index), reduced to the record fields the
benchmark writes, with the index built while writing. The BAM and BAI
formats are the SAMv1 specification's.
"""
import struct
import zlib
from dataclasses import dataclass

import numpy as np

BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
NT16 = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
_SEQ16 = np.array([NT16[c] for c in "ACGTN"], np.uint8)
CIGAR_CODE = {c: i for i, c in enumerate("MIDNSHP=X")}
LINEAR_SHIFT = 14
BLOCK = 0xFF00


@dataclass
class Record:
    qname: str
    flag: int
    tid: int
    pos: int            # 0-based
    mapq: int
    cigar: list         # [(op char, length)]
    mtid: int
    mpos: int
    tlen: int
    seq: np.ndarray     # codes 0..4
    qual: bytes         # Phred+33
    tags: list          # [(name, type char, value)]

    def ref_len(self) -> int:
        return sum(n for op, n in self.cigar if op in "MDN=X")


def reg2bin(beg: int, end: int) -> int:
    end -= 1
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return base + (beg >> shift)
    return 0


def encode(r: Record) -> bytes:
    name = r.qname.encode() + b"\x00"
    n = len(r.seq)
    body = struct.pack("<iiBBHHHiiii", r.tid, r.pos, len(name), r.mapq,
                       reg2bin(r.pos, r.pos + max(r.ref_len(), 1)),
                       len(r.cigar), r.flag, n, r.mtid, r.mpos, r.tlen)
    body += name
    body += b"".join(struct.pack("<I", (ln << 4) | CIGAR_CODE[op])
                     for op, ln in r.cigar)
    codes = _SEQ16[r.seq]
    if n % 2:
        codes = np.append(codes, 0)
    body += ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()
    body += (np.frombuffer(r.qual, np.uint8) - 33).astype(np.uint8).tobytes()
    for tag, typ, val in r.tags:
        if typ == "i":
            body += tag.encode() + b"i" + struct.pack("<i", int(val))
        elif typ == "A":
            body += tag.encode() + b"A" + val.encode()
        else:
            body += tag.encode() + b"Z" + str(val).encode() + b"\x00"
    return struct.pack("<i", len(body)) + body


class _Writer:
    """BGZF blocks of at most BLOCK bytes; virtual offsets of what is
    written."""

    def __init__(self, path: str):
        self.f = open(path, "wb")
        self.buf = bytearray()
        self.coff = 0

    def voffset(self) -> int:
        return (self.coff << 16) | len(self.buf)

    def write(self, data: bytes) -> None:
        if len(self.buf) + len(data) > BLOCK and self.buf:
            self.flush()
        self.buf += data
        while len(self.buf) >= BLOCK:
            self.flush(BLOCK)

    def flush(self, n=None) -> None:
        data = bytes(self.buf[:n] if n else self.buf)
        del self.buf[:len(data)]
        c = zlib.compressobj(6, zlib.DEFLATED, -15)
        cdata = c.compress(data) + c.flush()
        bsize = len(cdata) + 26
        block = (struct.pack("<BBBBIBBH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6)
                 + struct.pack("<BBHH", 66, 67, 2, bsize - 1) + cdata
                 + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF,
                               len(data)))
        self.f.write(block)
        self.coff += len(block)

    def close(self) -> None:
        if self.buf:
            self.flush()
        self.f.write(BGZF_EOF)
        self.f.close()


def write_bam(path: str, names, lengths, records) -> None:
    """`records` sorted by (tid, pos) to `path`, its index to path.bai."""
    w = _Writer(path)
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in zip(names, lengths))
    head = b"BAM\x01" + struct.pack("<i", len(text)) + text.encode()
    head += struct.pack("<i", len(names))
    for n, ln in zip(names, lengths):
        nb = n.encode() + b"\x00"
        head += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
    w.write(head)
    w.flush()
    bins = [dict() for _ in names]
    lin = [dict() for _ in names]
    for r in records:
        rec = encode(r)
        if len(w.buf) + len(rec) > BLOCK:
            w.flush()
        v0 = w.voffset()
        w.write(rec)
        v1 = w.voffset()
        end = r.pos + max(r.ref_len(), 1)
        chunks = bins[r.tid].setdefault(reg2bin(r.pos, end), [])
        if chunks and chunks[-1][1] >= v0:
            chunks[-1][1] = max(chunks[-1][1], v1)
        else:
            chunks.append([v0, v1])
        for k in range(r.pos >> LINEAR_SHIFT, ((end - 1) >> LINEAR_SHIFT) + 1):
            lin[r.tid].setdefault(k, v0)
    w.close()
    out = bytearray(b"BAI\x01") + struct.pack("<i", len(names))
    for t in range(len(names)):
        out += struct.pack("<i", len(bins[t]))
        for b in sorted(bins[t]):
            out += struct.pack("<Ii", b, len(bins[t][b]))
            for cb, ce in bins[t][b]:
                out += struct.pack("<QQ", cb, ce)
        n_lin = max(lin[t]) + 1 if lin[t] else 0
        out += struct.pack("<i", n_lin)
        last = 0
        for k in range(n_lin):
            last = lin[t].get(k, last)
            out += struct.pack("<Q", last)
    out += struct.pack("<Q", 0)
    with open(path + ".bai", "wb") as f:
        f.write(bytes(out))
