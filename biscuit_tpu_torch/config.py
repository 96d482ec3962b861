"""Alignment options with reference defaults.

Mirrors mem_opt_t (lib/aln/bwamem.h:54-124) with the defaults
from mem_opt_init (bwamem.c:77-128). Field-by-field parity is load-bearing:
most of these feed scoring/filter decisions that must match the reference
bit-for-bit.

Copy of biscuit_tpu/config.py: the code is the source's, so that the port
imports nothing of the JAX package; tests/test_torch_engine.py holds the
copy to its source.
"""
from dataclasses import dataclass, field
import math

import numpy as np

# MEM_F_* flags (bwamem.h)
MEM_F_PE = 0x2
MEM_F_NOPAIRING = 0x4
MEM_F_ALL = 0x8
MEM_F_NO_MULTI = 0x10
MEM_F_NO_RESCUE = 0x20
MEM_F_SELF_OVLP = 0x40
MEM_F_ALN_REG = 0x80
MEM_F_REF_HDR = 0x100
MEM_F_SOFTCLIP = 0x200
MEM_F_SMARTPE = 0x400
MEM_F_KEEP_SUPP_MAPQ = 0x1000


def fill_scmat(a: int, b: int, kind: str = "std") -> np.ndarray:
    """5x5 scoring matrix, row = reference base, col = read base
    (bwa.c:146-182). kind: std | ct (read T over ref C = match) | ga."""
    mat = np.full((5, 5), -1, dtype=np.int8)
    for i in range(4):
        for j in range(4):
            if kind == "ct" and i == 1 and j == 3:
                mat[i, j] = a
            elif kind == "ga" and i == 2 and j == 0:
                mat[i, j] = a
            else:
                mat[i, j] = a if i == j else -b
    return mat


@dataclass
class MemOpt:
    a: int = 1
    b: int = 2
    o_del: int = 6
    e_del: int = 1
    o_ins: int = 6
    e_ins: int = 1
    pen_unpaired: int = 17
    pen_clip5: int = 10
    pen_clip3: int = 10
    w: int = 100
    zdrop: int = 100
    max_mem_intv: int = 20
    T: int = 30
    flag: int = 0
    min_seed_len: int = 19
    min_chain_weight: int = 0
    max_chain_extend: int = 1 << 30
    split_factor: float = 1.5
    split_width: int = 10
    max_occ: int = 500
    max_chain_gap: int = 10000
    n_threads: int = 1
    chunk_size: int = 10000000
    mask_level: float = 0.50
    drop_ratio: float = 0.50
    XA_drop_ratio: float = 0.80
    mask_level_redun: float = 0.95
    mapQ_coef_len: float = 50.0
    # NB: the reference stores mapQ_coef_fac in an int field (bwamem.h:81),
    # so log(50)=3.912 TRUNCATES to 3 — reproducing that is required for
    # mapq parity in single-strand modes (caught by the -b/-f flag matrix)
    mapQ_coef_fac: float = field(default_factory=lambda: float(int(math.log(50))))
    max_ins: int = 5000
    max_matesw: int = 50
    max_XA_hits: int = 5
    max_XA_hits_alt: int = 5
    parent: int = 0
    bsstrand: int = 0
    clip5: int = 0
    clip3: int = 0
    min_base_qual: int = 0
    has_bc: int = 0
    adaptor1: bytes | None = None
    adaptor2: bytes | None = None

    def __post_init__(self):
        self.mat = fill_scmat(self.a, self.b, "std")
        self.ctmat = fill_scmat(self.a, self.b, "ct")
        self.gamat = fill_scmat(self.a, self.b, "ga")

    def update_a(self, overrides: set):
        """-A rescaling of dependent penalties unless individually overridden
        (align.c:169-182, update_a)."""
        if "b" not in overrides: self.b *= self.a
        if "T" not in overrides: self.T *= self.a
        if "o_del" not in overrides: self.o_del *= self.a
        if "e_del" not in overrides: self.e_del *= self.a
        if "o_ins" not in overrides: self.o_ins *= self.a
        if "e_ins" not in overrides: self.e_ins *= self.a
        if "zdrop" not in overrides: self.zdrop *= self.a
        if "pen_clip5" not in overrides: self.pen_clip5 *= self.a
        if "pen_clip3" not in overrides: self.pen_clip3 *= self.a
        if "pen_unpaired" not in overrides: self.pen_unpaired *= self.a
        self.__post_init__()
