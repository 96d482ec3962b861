"""POSIX lrand48 replica.

The reference index packer fills ambiguous (N) reference bases with
lrand48()&3 after srand48(11) (see lib/aln/bntseq.c:298-299,
495 — fixed seed 11). Byte-for-byte index parity therefore requires the exact
48-bit LCG stream, reproduced here from the POSIX definition (not from the
reference, which calls libc).

Copy of biscuit_tpu/utils/rng.py: the code is the source's, so that the port
imports nothing of the JAX package; tests/test_torch_engine.py holds the
copy to its source.
"""

_A = 0x5DEECE66D
_C = 0xB
_MASK = (1 << 48) - 1


class Lrand48:
    def __init__(self, seed: int = 11):
        self.srand48(seed)

    def srand48(self, seed: int) -> None:
        # POSIX: the high 32 bits of Xi are set to seed, low 16 bits to 0x330E
        self.x = (((seed & 0xFFFFFFFF) << 16) | 0x330E) & _MASK

    def next(self) -> int:
        """Return the next lrand48() value (31-bit non-negative int)."""
        self.x = (_A * self.x + _C) & _MASK
        return self.x >> 17
