"""FASTA parsing and 2-bit genome packing.

Reproduces the reference packer semantics (lib/aln/bntseq.c:
add1/bis_add1): nst_nt4 base coding, ambiguous-base (N) runs recorded as
"holes" and filled with lrand48()&3 from a fixed seed-11 stream, contig
annotations with cumulative offsets.

Copy of biscuit_tpu/index/fasta.py: the code is the source's, so that the port
imports nothing of the JAX package; tests/test_torch_engine.py holds the
copy to its source.
"""
from dataclasses import dataclass, field
from typing import List, Tuple
import gzip

import numpy as np

from ..utils.rng import Lrand48

# nst_nt4 coding: A=0 C=1 G=2 T=3, '-'=5, everything else 4
NT4 = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    NT4[_b] = _i
    NT4[_b + 32] = _i  # lowercase
NT4[ord("-")] = 5


@dataclass
class Ann:
    name: str
    anno: str
    offset: int
    length: int
    n_ambs: int
    gi: int = 0
    is_alt: int = 0


@dataclass
class Amb:
    offset: int
    length: int
    amb: str


@dataclass
class PackedGenome:
    """Forward-strand packed genome + annotations (reference bntseq_t)."""
    codes: np.ndarray  # uint8[l_pac], 0..3, N already randomized
    anns: List[Ann] = field(default_factory=list)
    ambs: List[Amb] = field(default_factory=list)
    seed: int = 11

    @property
    def l_pac(self) -> int:
        return len(self.codes)


def read_fasta(path: str) -> List[Tuple[str, str, bytes]]:
    """Return [(name, comment, seq_bytes)] in file order."""
    opener = gzip.open if path.endswith(".gz") else open
    out = []
    name = comment = None
    chunks: List[bytes] = []
    with opener(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    out.append((name, comment, b"".join(chunks)))
                hdr = line[1:].split(None, 1)
                name = hdr[0].decode()
                comment = hdr[1].decode() if len(hdr) > 1 else ""
                chunks = []
            elif line:
                chunks.append(line)
    if name is not None:
        out.append((name, comment, b"".join(chunks)))
    return out


def pack_genome(path: str, seed: int = 11) -> PackedGenome:
    """Pack a FASTA into forward 2-bit codes with the reference's exact
    N-randomization stream and hole bookkeeping (bntseq.c:236-282,459-507)."""
    rng = Lrand48(seed)
    pg = PackedGenome(codes=np.empty(0, dtype=np.uint8), seed=seed)
    all_codes: List[np.ndarray] = []
    offset = 0
    for name, comment, seq in read_fasta(path):
        raw = np.frombuffer(seq, dtype=np.uint8)
        codes = NT4[raw].copy()
        amb_mask = codes >= 4
        n_ambs = 0
        if amb_mask.any():
            # record runs of *identical* ambiguous characters (the reference
            # merges a run only while the literal character repeats)
            idx = np.nonzero(amb_mask)[0]
            run_start = idx[0]
            run_char = raw[idx[0]]
            run_len = 1
            prev = idx[0]
            for i in idx[1:]:
                if i == prev + 1 and raw[i] == run_char:
                    run_len += 1
                else:
                    pg.ambs.append(Amb(offset + int(run_start), int(run_len), chr(run_char)))
                    n_ambs += 1
                    run_start, run_char, run_len = i, raw[i], 1
                prev = i
            pg.ambs.append(Amb(offset + int(run_start), int(run_len), chr(run_char)))
            n_ambs += 1
            # fill with the lrand48 stream, in sequence order
            for i in idx:
                codes[i] = rng.next() & 3
        pg.anns.append(Ann(name, comment or "(null)", offset, len(codes), n_ambs))
        offset += len(codes)
        all_codes.append(codes)
    pg.codes = np.concatenate(all_codes) if all_codes else np.empty(0, dtype=np.uint8)
    return pg


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack 0..3 codes into the reference .pac byte layout: base i at bit
    shift ((~i & 3) << 1), i.e. first base in the two MSBs of each byte."""
    n = len(codes)
    padded = np.zeros((n + 3) // 4 * 4, dtype=np.uint8)
    padded[:n] = codes
    quads = padded.reshape(-1, 4)
    return (quads[:, 0] << 6 | quads[:, 1] << 4 | quads[:, 2] << 2 | quads[:, 3]).astype(np.uint8)


def unpack_2bit(pac: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack_2bit for the first n bases."""
    b = np.asarray(pac, dtype=np.uint8)
    out = np.empty(len(b) * 4, dtype=np.uint8)
    out[0::4] = b >> 6
    out[1::4] = (b >> 4) & 3
    out[2::4] = (b >> 2) & 3
    out[3::4] = b & 3
    return out[:n]


def write_pac(path: str, codes: np.ndarray) -> None:
    """Write a reference-format .pac file (bntseq.c:317-330): packed bytes,
    then a pad byte if l%4==0, then a final byte holding l%4."""
    pac = pack_2bit(codes)
    l = len(codes)
    with open(path, "wb") as f:
        f.write(pac.tobytes())
        if l % 4 == 0:
            f.write(b"\x00")
        f.write(bytes([l % 4]))


def read_pac(path: str) -> np.ndarray:
    """Read a reference-format .pac file into uint8 codes."""
    with open(path, "rb") as f:
        data = f.read()
    rem = data[-1]
    body = np.frombuffer(data[:-1], dtype=np.uint8)
    n = (len(body) - (1 if rem == 0 else 0)) * 4
    if rem:
        n = (len(body) - 1) * 4 + rem
    return unpack_2bit(body, n)
