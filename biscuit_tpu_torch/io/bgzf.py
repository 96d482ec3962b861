"""BGZF (blocked gzip) reader/writer — replaces the htslib bgzf dependency
(reference links htslib 1.18; see SURVEY.md §2e). Pure Python over zlib;
the C++ native accelerator can swap in later for throughput.

Copy of biscuit_tpu/io/bgzf.py: the code is the source's, so that the port
imports nothing of the JAX package; tests/test_torch_engine.py holds the
copy to its source.
"""
import struct
import zlib
from typing import BinaryIO, Iterator

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
MAX_BLOCK = 65536


def _read_block(f: BinaryIO) -> bytes | None:
    hdr = f.read(12)
    if len(hdr) == 0:
        return None
    if len(hdr) < 12:
        raise IOError("truncated BGZF header")
    magic1, magic2, _cm, flg, _mtime, _xfl, _os, xlen = struct.unpack("<BBBBIBBH", hdr)
    if magic1 != 0x1F or magic2 != 0x8B:
        raise IOError("not a BGZF/gzip stream")
    extra = f.read(xlen)
    bsize = None
    off = 0
    while off + 4 <= xlen:
        si1, si2, slen = struct.unpack_from("<BBH", extra, off)
        if si1 == 66 and si2 == 67 and slen == 2:
            bsize = struct.unpack_from("<H", extra, off + 4)[0] + 1
        off += 4 + slen
    if bsize is None:
        raise IOError("missing BGZF BC subfield")
    cdata = f.read(bsize - 12 - xlen - 8)
    crc, isize = struct.unpack("<II", f.read(8))
    data = zlib.decompress(cdata, -15)
    if len(data) != isize:
        raise IOError("BGZF block size mismatch")
    return data


def decompress(path: str) -> bytes:
    """Read a whole BGZF file into bytes."""
    chunks = []
    with open(path, "rb") as f:
        while True:
            b = _read_block(f)
            if b is None:
                break
            chunks.append(b)
    return b"".join(chunks)


def iter_blocks(path: str) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            b = _read_block(f)
            if b is None:
                return
            if b:
                yield b


class BGZFWriter:
    def __init__(self, path: str):
        self.f = open(path, "wb")
        self.buf = bytearray()

    def write(self, data: bytes) -> None:
        self.buf += data
        while len(self.buf) >= 0xFF00:
            self._flush_block(self.buf[:0xFF00])
            del self.buf[:0xFF00]

    def _flush_block(self, data: bytes) -> None:
        c = zlib.compressobj(6, zlib.DEFLATED, -15)
        cdata = c.compress(bytes(data)) + c.flush()
        bsize = len(cdata) + 25 + 1
        hdr = struct.pack("<BBBBIBBH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6)
        hdr += struct.pack("<BBHH", 66, 67, 2, bsize - 1)
        self.f.write(hdr + cdata + struct.pack("<II", zlib.crc32(bytes(data)) & 0xFFFFFFFF, len(data)))

    def close(self) -> None:
        if self.buf:
            self._flush_block(self.buf)
            self.buf = bytearray()
        self.f.write(BGZF_EOF)
        self.f.close()
