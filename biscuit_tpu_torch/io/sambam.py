"""SAM/BAM record model and IO — the framework's htslib replacement surface
(reference depends on htslib for BAM/SAM/aux/iterators; SURVEY.md §2e).

Supports: SAM text read/write, BAM (BGZF) read/write, aux tags, and region
queries: streamed over a .bai index when one exists (io/bai.py, `biscuit
bamindex`), else bucketed in memory for small coordinate-sorted inputs.

Copy of biscuit_tpu/io/sambam.py: the code is the source's, so that the port
imports nothing of the JAX package; tests/test_torch_engine.py holds the
copy to its source.
"""
import re
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from . import bgzf

CIGAR_OPS = "MIDNSHP=X"
CIGAR_CONSUME_REF = {0, 2, 3, 7, 8}
CIGAR_CONSUME_QUERY = {0, 1, 4, 7, 8}
NT16 = "=ACMGRSVTWYHKDBN"
NT16_MAP = {c: i for i, c in enumerate(NT16)}

FLAG_PAIRED = 0x1
FLAG_PROPER = 0x2
FLAG_UNMAP = 0x4
FLAG_MUNMAP = 0x8
FLAG_REVERSE = 0x10
FLAG_MREVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800


@dataclass
class AlnRecord:
    qname: str
    flag: int
    tid: int          # -1 if unmapped/'*'
    pos: int          # 0-based leftmost
    mapq: int
    cigar: List[Tuple[int, int]]  # (op, len), op indexes CIGAR_OPS
    mtid: int
    mpos: int
    tlen: int
    seq: str
    qual: str         # ASCII-33 string or "*"
    tags: Dict[str, Tuple[str, object]] = field(default_factory=dict)

    @property
    def l_qseq(self) -> int:
        return 0 if self.seq == "*" else len(self.seq)

    def rlen(self) -> int:
        """bam_cigar2rlen: reference length consumed."""
        return sum(l for op, l in self.cigar if op in CIGAR_CONSUME_REF)

    def get_tag(self, name: str):
        t = self.tags.get(name)
        return None if t is None else t[1]

    def cigar_str(self) -> str:
        if not self.cigar:
            return "*"
        return "".join(f"{l}{CIGAR_OPS[op]}" for op, l in self.cigar)


@dataclass
class SamHeader:
    names: List[str] = field(default_factory=list)    # tid -> name
    lengths: List[int] = field(default_factory=list)  # tid -> len
    lines: List[str] = field(default_factory=list)    # all raw header lines
    _name2tid: Dict[str, int] = field(default_factory=dict)

    def name2tid(self, name: str) -> int:
        return self._name2tid.get(name, -1)

    def add_sq(self, name: str, length: int) -> None:
        self._name2tid[name] = len(self.names)
        self.names.append(name)
        self.lengths.append(length)


def parse_cigar(s: str) -> List[Tuple[int, int]]:
    if s == "*":
        return []
    return [(CIGAR_OPS.index(m[1]), int(m[0]))
            for m in re.findall(r"(\d+)([MIDNSHP=X])", s)]


_TAG_RE = None


def parse_tag(field_: str) -> Tuple[str, Tuple[str, object]]:
    name, typ, val = field_.split(":", 2)
    if typ == "i":
        val = int(val)
    elif typ == "f":
        val = float(val)
    elif typ == "B":
        # same in-memory shape as the BAM codec: (subtype, [values])
        parts = val.split(",")
        sub = parts[0]
        conv = float if sub in ("f", "d") else int
        val = (sub, [conv(x) for x in parts[1:]])
    return name, (typ, val)


def parse_sam_line(line: str, hdr: SamHeader) -> AlnRecord:
    f = line.rstrip("\n").split("\t")
    tags = {}
    for t in f[11:]:
        n, v = parse_tag(t)
        tags[n] = v
    return AlnRecord(
        qname=f[0], flag=int(f[1]),
        tid=hdr.name2tid(f[2]) if f[2] != "*" else -1,
        pos=int(f[3]) - 1, mapq=int(f[4]), cigar=parse_cigar(f[5]),
        mtid=(hdr.name2tid(f[6]) if f[6] != "*" else -1) if f[6] != "=" else hdr.name2tid(f[2]),
        mpos=int(f[7]) - 1, tlen=int(f[8]), seq=f[9], qual=f[10], tags=tags)


def format_sam_record(r: AlnRecord, hdr: SamHeader) -> str:
    rname = hdr.names[r.tid] if r.tid >= 0 else "*"
    if r.mtid < 0:
        mname = "*"
    elif r.mtid == r.tid:
        mname = "="
    else:
        mname = hdr.names[r.mtid]
    parts = [r.qname, str(r.flag), rname, str(r.pos + 1), str(r.mapq),
             r.cigar_str(), mname, str(r.mpos + 1), str(r.tlen), r.seq, r.qual]
    for name, (typ, val) in r.tags.items():
        if typ == "f":
            sval = f"{val:g}"
        elif typ == "B":
            sub, vals = val
            sval = sub + "," + ",".join(str(v) for v in vals)
        else:
            sval = str(val)
        parts.append(f"{name}:{typ}:{sval}")
    return "\t".join(parts)


# ---------------------------------------------------------------------------
# BAM binary codec
# ---------------------------------------------------------------------------

def _parse_bam_header(data: bytes) -> Tuple[SamHeader, int]:
    if data[:4] != b"BAM\x01":
        raise IOError("not a BAM file")
    l_text = struct.unpack_from("<i", data, 4)[0]
    text = data[8:8 + l_text].rstrip(b"\x00").decode()
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    hdr = SamHeader()
    hdr.lines = [l for l in text.split("\n") if l]
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", data, off)[0]
        off += 4
        name = data[off:off + l_name - 1].decode()
        off += l_name
        l_ref = struct.unpack_from("<i", data, off)[0]
        off += 4
        hdr.add_sq(name, l_ref)
    return hdr, off


def _decode_bam_record(data: bytes, off: int) -> Tuple[AlnRecord, int]:
    block_size = struct.unpack_from("<i", data, off)[0]
    off += 4
    end = off + block_size
    (tid, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq, mtid, mpos,
     tlen) = struct.unpack_from("<iiBBHHHiiii", data, off)
    p = off + 32
    qname = data[p:p + l_read_name - 1].decode()
    p += l_read_name
    cigar = []
    for _ in range(n_cigar):
        v = struct.unpack_from("<I", data, p)[0]
        cigar.append((v & 0xF, v >> 4))
        p += 4
    nbytes = (l_seq + 1) // 2
    seq_chars = []
    for i in range(l_seq):
        b = data[p + (i >> 1)]
        seq_chars.append(NT16[(b >> 4) if i % 2 == 0 else (b & 0xF)])
    seq = "".join(seq_chars) if l_seq else "*"
    p += nbytes
    qual_raw = data[p:p + l_seq]
    qual = "*" if (not l_seq or (qual_raw and qual_raw[0] == 0xFF)) else \
        "".join(chr(q + 33) for q in qual_raw)
    p += l_seq
    tags: Dict[str, Tuple[str, object]] = {}
    while p < end:
        name = data[p:p + 2].decode()
        typ = chr(data[p + 2])
        p += 3
        if typ in "cC":
            val = struct.unpack_from("<b" if typ == "c" else "<B", data, p)[0]
            p += 1
            tags[name] = ("i", val)
        elif typ in "sS":
            val = struct.unpack_from("<h" if typ == "s" else "<H", data, p)[0]
            p += 2
            tags[name] = ("i", val)
        elif typ in "iI":
            val = struct.unpack_from("<i" if typ == "i" else "<I", data, p)[0]
            p += 4
            tags[name] = ("i", val)
        elif typ == "f":
            val = struct.unpack_from("<f", data, p)[0]
            p += 4
            tags[name] = ("f", val)
        elif typ == "A":
            tags[name] = ("A", chr(data[p]))
            p += 1
        elif typ in "ZH":
            q = data.index(b"\x00", p)
            tags[name] = (typ, data[p:q].decode())
            p = q + 1
        elif typ == "B":
            sub = chr(data[p])
            n = struct.unpack_from("<i", data, p + 1)[0]
            sz = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}[sub]
            vals = list(struct.unpack_from(f"<{n}{fmt}", data, p + 5))
            tags[name] = ("B", (sub, vals))
            p += 5 + n * sz
        else:
            raise IOError(f"unknown BAM tag type {typ}")
    rec = AlnRecord(qname=qname, flag=flag, tid=tid, pos=pos, mapq=mapq,
                    cigar=cigar, mtid=mtid, mpos=mpos, tlen=tlen, seq=seq,
                    qual=qual, tags=tags)
    return rec, end


def _encode_bam_record(r: AlnRecord, hdr: SamHeader) -> bytes:
    name_b = r.qname.encode() + b"\x00"
    l_seq = r.l_qseq
    body = struct.pack("<iiBBHHHiiii", r.tid, r.pos, len(name_b), r.mapq,
                       _reg2bin(r.pos, r.pos + max(r.rlen(), 1)), len(r.cigar),
                       r.flag, l_seq, r.mtid, r.mpos, r.tlen)
    body += name_b
    for op, ln in r.cigar:
        body += struct.pack("<I", (ln << 4) | op)
    sb = bytearray((l_seq + 1) // 2)
    for i, ch in enumerate(r.seq if r.seq != "*" else ""):
        code = NT16_MAP.get(ch.upper(), 15)
        if i % 2 == 0:
            sb[i >> 1] |= code << 4
        else:
            sb[i >> 1] |= code
    body += bytes(sb)
    if r.qual == "*" or not r.qual:
        body += b"\xff" * l_seq
    else:
        body += bytes((ord(c) - 33) & 0xFF for c in r.qual)
    for name, (typ, val) in r.tags.items():
        nb = name.encode()
        if typ == "i":
            body += nb + b"i" + struct.pack("<i", int(val))
        elif typ == "f":
            body += nb + b"f" + struct.pack("<f", float(val))
        elif typ == "A":
            body += nb + b"A" + val.encode()
        elif typ in "ZH":
            body += nb + typ.encode() + str(val).encode() + b"\x00"
        elif typ == "B":
            sub, vals = val
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}[sub]
            body += nb + b"B" + sub.encode() + struct.pack("<i", len(vals))
            body += struct.pack(f"<{len(vals)}{fmt}", *vals)
    return struct.pack("<i", len(body)) + body


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


# ---------------------------------------------------------------------------
# file-level API
# ---------------------------------------------------------------------------

def _bam_header_end(data: bytes):
    """Byte offset just past a complete BAM header in `data`, or None if
    more bytes are needed."""
    if len(data) < 8:
        return None
    (l_text,) = struct.unpack_from("<i", data, 4)
    need = 8 + l_text + 4
    if len(data) < need:
        return None
    (n_ref,) = struct.unpack_from("<i", data, 8 + l_text)
    off = need
    for _ in range(n_ref):
        if len(data) < off + 4:
            return None
        (l_name,) = struct.unpack_from("<i", data, off)
        if len(data) < off + 4 + l_name + 4:
            return None
        off += 4 + l_name + 4
    return off


def _parse_bam_header_streaming(path: str) -> SamHeader:
    """Read just enough BGZF blocks to parse the BAM header (used by the
    .bai streaming mode so the records are never loaded wholesale)."""
    data = b""
    with open(path, "rb") as f:
        while True:
            off = _bam_header_end(data)
            if off is not None:
                hdr, _ = _parse_bam_header(data[:off])
                return hdr
            b = bgzf._read_block(f)
            if b is None:
                raise IOError(f"{path}: truncated BAM header")
            data += b


def _is_bam(path: str) -> bool:
    with open(path, "rb") as f:
        magic = f.read(2)
    return magic == b"\x1f\x8b"


class AlignmentFile:
    """Read a SAM (text) or BAM (BGZF) file; supports full iteration and
    region queries over coordinate-sorted data. With a .bai index alongside
    (htslib/samtools-compatible; see io/bai.py) the BAM is streamed and
    region queries seek via the index instead of loading into memory."""

    def __init__(self, path: str):
        import os

        self.path = path
        self.header = SamHeader()
        self._records: List[AlnRecord] = []
        self._bai = None
        if _is_bam(path) and os.path.exists(path + ".bai"):
            from .bai import BaiIndex
            self._bai = BaiIndex.read(path + ".bai")
            self.header = _parse_bam_header_streaming(path)
        elif _is_bam(path):
            data = bgzf.decompress(path)
            self.header, off = _parse_bam_header(data)
            while off < len(data):
                rec, off = _decode_bam_record(data, off)
                self._records.append(rec)
        else:
            with open(path) as f:
                for line in f:
                    if line.startswith("@"):
                        self.header.lines.append(line.rstrip("\n"))
                        if line.startswith("@SQ"):
                            d = dict(x.split(":", 1) for x in line.rstrip("\n").split("\t")[1:])
                            self.header.add_sq(d["SN"], int(d["LN"]))
                    elif line.strip():
                        self._records.append(parse_sam_line(line, self.header))
        self._by_tid: Optional[Dict[int, List[AlnRecord]]] = None

    def __iter__(self) -> Iterator[AlnRecord]:
        if self._bai is not None:
            return self._stream_from(None)
        return iter(self._records)

    def _stream_from(self, voffset) -> Iterator[AlnRecord]:
        """Decode records from the BGZF stream, starting at a virtual offset
        (None = after the header)."""
        with open(self.path, "rb") as f:
            buf = b""
            if voffset is None:
                # skip the header: accumulate blocks until it parses whole
                pending = b""
                while True:
                    end_off = _bam_header_end(pending)
                    if end_off is not None:
                        buf = pending[end_off:]
                        break
                    b = bgzf._read_block(f)
                    if b is None:
                        return
                    pending += b
            else:
                f.seek(voffset >> 16)
                first = bgzf._read_block(f)
                if first is None:
                    return
                buf = first[voffset & 0xFFFF:]
            while True:
                while len(buf) >= 4:
                    (sz,) = struct.unpack_from("<i", buf, 0)
                    if len(buf) < 4 + sz:
                        break
                    rec, _ = _decode_bam_record(buf[:4 + sz], 0)
                    buf = buf[4 + sz:]
                    yield rec
                nxt = bgzf._read_block(f)
                if nxt is None:
                    return
                buf += nxt

    def _index(self):
        if self._by_tid is None:
            self._by_tid = {}
            for r in self._records:
                self._by_tid.setdefault(r.tid, []).append(r)
            for recs in self._by_tid.values():
                recs.sort(key=lambda r: r.pos)
        return self._by_tid

    def fetch(self, tid: int, beg: int, end: int) -> Iterator[AlnRecord]:
        """Records overlapping [beg, end) (0-based), by position, like
        sam_itr_queryi."""
        if self._bai is not None:
            voff = self._bai.min_offset(tid, beg, end)
            if voff is None:
                return
            for r in self._stream_from(voff):
                if r.tid != tid:
                    if r.tid > tid or r.tid < 0:
                        break
                    continue
                if r.pos >= end:
                    break
                if r.pos + max(r.rlen(), 1) > beg:
                    yield r
            return
        recs = self._index().get(tid, [])
        # linear scan from a conservative start (reads are short)
        for r in recs:
            if r.pos >= end:
                break
            if r.pos + max(r.rlen(), 1) > beg:
                yield r


def stream_bam_records(path: str) -> Iterator[AlnRecord]:
    """Stream-decode a BAM without loading it wholesale (no index needed):
    used by the external sort and anywhere order-only iteration suffices."""
    with open(path, "rb") as f:
        data = b""
        # header
        while True:
            off = _bam_header_end(data)
            if off is not None:
                buf = data[off:]
                break
            b = bgzf._read_block(f)
            if b is None:
                raise IOError(f"{path}: truncated BAM header")
            data += b
        while True:
            while len(buf) >= 4:
                (sz,) = struct.unpack_from("<i", buf, 0)
                if len(buf) < 4 + sz:
                    break
                rec, _ = _decode_bam_record(buf[:4 + sz], 0)
                buf = buf[4 + sz:]
                yield rec
            nxt = bgzf._read_block(f)
            if nxt is None:
                return
            buf += nxt


def write_bam(path: str, hdr: SamHeader, records: List[AlnRecord]) -> None:
    w = bgzf.BGZFWriter(path)
    text = ("\n".join(hdr.lines) + "\n").encode() if hdr.lines else b""
    head = b"BAM\x01" + struct.pack("<i", len(text)) + text
    head += struct.pack("<i", len(hdr.names))
    for name, ln in zip(hdr.names, hdr.lengths):
        nb = name.encode() + b"\x00"
        head += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
    w.write(head)
    for r in records:
        w.write(_encode_bam_record(r, hdr))
    w.close()


def write_sam(path, hdr: SamHeader, records: List[AlnRecord]) -> None:
    close = False
    if isinstance(path, str):
        f = open(path, "w")
        close = True
    else:
        f = path
    for line in hdr.lines:
        f.write(line + "\n")
    for r in records:
        f.write(format_sam_record(r, hdr) + "\n")
    if close:
        f.close()
