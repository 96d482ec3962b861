"""BAI (BAM index) reader/writer + region-query support.

Replaces the htslib hts_idx/.bai dependency (SURVEY.md §2e): standard BAI
format (SAMv1 spec §5.2) — binning scheme R-tree bins (6 levels, 16 kb
leaves) plus the 16 kb linear index of virtual file offsets — so indexes
interoperate with samtools/htslib in both directions.

Copy of biscuit_tpu/io/bai.py: the code is the source's, so that the port
imports nothing of the JAX package; tests/test_torch_engine.py holds the
copy to its source.
"""
import struct
from typing import Dict, List, Tuple

from . import bgzf

BAI_MAGIC = b"BAI\x01"
LINEAR_SHIFT = 14  # 16 kb windows
MAX_BIN = 37450    # (8^6-1)/7+1


def reg2bin(beg: int, end: int) -> int:
    """SAMv1 spec: smallest bin containing [beg, end)."""
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


def reg2bins(beg: int, end: int) -> List[int]:
    """All bins overlapping [beg, end)."""
    end -= 1
    bins = [0]
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return bins


class BaiRef:
    def __init__(self):
        self.bins: Dict[int, List[Tuple[int, int]]] = {}
        self.ioffsets: List[int] = []


class BaiIndex:
    def __init__(self, n_ref: int = 0):
        self.refs = [BaiRef() for _ in range(n_ref)]
        self.n_no_coor = 0

    @classmethod
    def read(cls, path: str) -> "BaiIndex":
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != BAI_MAGIC:
            raise IOError(f"{path}: not a BAI file")
        try:
            off = 4
            (n_ref,) = struct.unpack_from("<i", data, off)
            off += 4
            # corrupt counts must not drive unbounded loops: every ref costs
            # >= 8 bytes, every bin >= 8, every chunk 16
            if n_ref < 0 or n_ref * 8 > len(data):
                raise IOError(f"{path}: corrupt BAI (n_ref={n_ref})")
            idx = cls(n_ref)
            for r in range(n_ref):
                (n_bin,) = struct.unpack_from("<i", data, off)
                off += 4
                if n_bin < 0 or off + n_bin * 8 > len(data):
                    raise IOError(f"{path}: corrupt BAI (n_bin={n_bin})")
                for _ in range(n_bin):
                    bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                    off += 8
                    if n_chunk < 0 or off + n_chunk * 16 > len(data):
                        raise IOError(
                            f"{path}: corrupt BAI (n_chunk={n_chunk})")
                    chunks = []
                    for _ in range(n_chunk):
                        cb, ce = struct.unpack_from("<QQ", data, off)
                        off += 16
                        chunks.append((cb, ce))
                    idx.refs[r].bins[bin_id] = chunks
                (n_intv,) = struct.unpack_from("<i", data, off)
                off += 4
                if n_intv < 0 or off + n_intv * 8 > len(data):
                    raise IOError(f"{path}: corrupt BAI (n_intv={n_intv})")
                idx.refs[r].ioffsets = list(
                    struct.unpack_from(f"<{n_intv}Q", data, off))
                off += 8 * n_intv
            if off + 8 <= len(data):
                (idx.n_no_coor,) = struct.unpack_from("<Q", data, off)
            return idx
        except struct.error as e:
            raise IOError(f"{path}: corrupt BAI index: {e}") from e

    def write(self, path: str) -> None:
        out = bytearray(BAI_MAGIC)
        out += struct.pack("<i", len(self.refs))
        for ref in self.refs:
            out += struct.pack("<i", len(ref.bins))
            for bin_id in sorted(ref.bins):
                chunks = ref.bins[bin_id]
                out += struct.pack("<Ii", bin_id, len(chunks))
                for cb, ce in chunks:
                    out += struct.pack("<QQ", cb, ce)
            out += struct.pack("<i", len(ref.ioffsets))
            for v in ref.ioffsets:
                out += struct.pack("<Q", v)
        out += struct.pack("<Q", self.n_no_coor)
        with open(path, "wb") as f:
            f.write(bytes(out))

    # ---- query -------------------------------------------------------
    def min_offset(self, tid: int, beg: int, end: int):
        """Smallest virtual offset that can contain a record overlapping
        [beg, end), or None if the reference has no indexed data."""
        if tid < 0 or tid >= len(self.refs):
            return None
        ref = self.refs[tid]
        if not ref.bins:
            return None
        lin = 0
        w = beg >> LINEAR_SHIFT
        if ref.ioffsets:
            lin = ref.ioffsets[min(w, len(ref.ioffsets) - 1)]
        best = None
        for b in reg2bins(beg, end):
            for cb, ce in ref.bins.get(b, ()):
                if ce <= lin:
                    continue
                cand = max(cb, lin)
                if best is None or cand < best:
                    best = cand
        return best


def build_bai(bam_path: str) -> BaiIndex:
    """Index a coordinate-sorted BAM: walk blocks once, tracking each
    record's starting virtual offset."""
    from .sambam import _parse_bam_header, _decode_bam_record

    blocks: List[Tuple[int, bytes]] = []  # (compressed offset, data)
    with open(bam_path, "rb") as f:
        while True:
            coff = f.tell()
            b = bgzf._read_block(f)
            if b is None:
                break
            blocks.append((coff, b))
    # concat + map concat position -> virtual offset
    starts = []
    total = 0
    for coff, b in blocks:
        starts.append((total, coff, len(b)))
        total += len(b)
    data = b"".join(b for _c, b in blocks)

    import bisect
    start_keys = [s[0] for s in starts]

    def voffset(pos: int) -> int:
        i = bisect.bisect_right(start_keys, pos) - 1
        s0, coff, _ln = starts[i]
        return (coff << 16) | (pos - s0)

    hdr, off = _parse_bam_header(data)
    idx = BaiIndex(len(hdr.names))
    # per-record accumulation
    while off < len(data):
        vstart = voffset(off)
        rec, off2 = _decode_bam_record(data, off)
        vend = voffset(off2) if off2 < len(data) else (
            (blocks[-1][0] << 16) | len(blocks[-1][1])) if blocks else vstart
        off = off2
        if rec.tid < 0 or rec.pos < 0:
            idx.n_no_coor += 1
            continue
        ref = idx.refs[rec.tid]
        end = rec.pos + max(rec.rlen(), 1)
        b = reg2bin(rec.pos, end)
        chunks = ref.bins.setdefault(b, [])
        if chunks and chunks[-1][1] >= vstart:
            chunks[-1] = (chunks[-1][0], max(chunks[-1][1], vend))
        else:
            chunks.append((vstart, vend))
        w_beg, w_end = rec.pos >> LINEAR_SHIFT, (end - 1) >> LINEAR_SHIFT
        if len(ref.ioffsets) <= w_end:
            ref.ioffsets.extend([0] * (w_end + 1 - len(ref.ioffsets)))
        for w in range(w_beg, w_end + 1):
            if ref.ioffsets[w] == 0 or vstart < ref.ioffsets[w]:
                ref.ioffsets[w] = vstart
    # fill linear-index gaps with the previous value (htslib convention)
    for ref in idx.refs:
        last = 0
        for i, v in enumerate(ref.ioffsets):
            if v == 0:
                ref.ioffsets[i] = last
            else:
                last = v
    return idx
