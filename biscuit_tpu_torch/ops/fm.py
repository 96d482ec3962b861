"""FM-index rank/extension/SA-lookup ops: the numpy ground truth.

Copy of FMNumpy and popcount64 from biscuit_tpu/ops/fm.py (reference
behavior: lib/aln/bwt.c bwt_occ4/bwt_2occ4/bwt_extend/
bwt_sa). The batched JAX functions of that module are not copied: the
port's batched SA walk is ops/seed_batch.sa_batch.

Rank-space conventions (careful — parity-critical):
  k ranges over [-1, seq_len]; the '$' row (rank `primary`) is not stored in
  the BWT string, so char access first applies k -= (k >= primary).
"""
import numpy as np

from ..index.fmindex import StrandIndex

OCC_SHIFT = 7  # 128 bases/block
WORDS_PER_BLOCK = 8


# ---------------------------------------------------------------------------
# numpy ground truth
# ---------------------------------------------------------------------------

class FMNumpy:
    """Host FM-index ops over StrandIndex arrays.

    Two granularities: vectorized numpy (occ4/extend/sa over arrays) and a
    pure-Python-int scalar fast path (occ4_s/extend_s/sa_s) used by the host
    SMEM/chaining pipeline, where per-call numpy overhead dominates.
    """

    def __init__(self, s: StrandIndex):
        # Keep words/occ_cp in their stored dtypes: asarray is a no-copy view
        # then, so an mmap-loaded index stays page-shared across processes.
        # occ_cp is stored uint32 (occ_checkpoints) and widened per-gather at
        # the use site instead of materializing an int64 copy per process.
        self.words = np.asarray(s.words, np.uint32)
        self.occ_cp = np.asarray(s.occ_cp)
        self.L2 = np.asarray(s.L2, np.int64)
        self.primary = int(s.primary)
        self.seq_len = int(s.seq_len)
        self.sa_samples = s.sa_samples.astype(np.int64)  # copy: [0] set below
        # rank 0 is the '$' row; the reference stores (bwtint_t)-1 there so
        # that a walk ending at rank 0 yields add - 1 via unsigned wrap
        # (bwt.c:84,94-96). Use a true -1 for the same arithmetic.
        self.sa_samples[0] = -1
        self.sa_intv = int(getattr(s, "sa_intv", 32))
        self._sa_shift = self.sa_intv.bit_length() - 1

    # scalar fast-path tables (Python lists/ints) are built lazily on first
    # *_s call: the native C++ engine never touches them, and building them
    # eagerly costs minutes + GBs on large (100 Mbp+) genomes
    _SCALAR_ATTRS = ("_occ_w", "_words_l", "_L2_l", "_sa_l", "_totals")

    def __getattr__(self, name):
        if name in FMNumpy._SCALAR_ATTRS:
            self._build_scalar()
            return object.__getattribute__(self, name)
        raise AttributeError(name)

    def _build_scalar(self):
        n_words = len(self.words)
        w64 = self.words.astype(np.uint64)
        per_word = np.empty((n_words, 4), dtype=np.int64)
        for c in range(4):
            t = ((w64 if c & 2 else ~w64) >> np.uint64(1)) \
                & (w64 if c & 1 else ~w64) & np.uint64(0x55555555)
            per_word[:, c] = popcount64(t)
        cum = np.zeros((n_words + 1, 4), dtype=np.int64)
        cum[1:] = per_word.cumsum(axis=0)
        # trim counts past seq_len (padding bases in the last word are zeros
        # = base A; subtract them)
        pad = n_words * 16 - self.seq_len
        if pad:
            cum[n_words, 0] -= pad
        self._occ_w = [tuple(int(x) for x in row) for row in cum]
        self._words_l = [int(x) for x in self.words]
        self._L2_l = tuple(int(x) for x in self.L2)
        self._sa_l = [int(x) for x in self.sa_samples]
        self._totals = tuple(int(self.L2[c + 1] - self.L2[c]) for c in range(4))

    # ---- scalar fast path (pure ints) ----

    def set_intv_s(self, other: "FMNumpy", c: int):
        return (self._L2_l[c] + 1, other._L2_l[3 - c] + 1,
                self._L2_l[c + 1] - self._L2_l[c])

    def occ4_s(self, k: int):
        """Scalar occ4; k in [-1, seq_len]."""
        if k < 0:
            return (0, 0, 0, 0)
        if k == self.seq_len:
            return self._totals
        if k >= self.primary:
            k -= 1
        w = k >> 4
        t_low = (~k) & 15
        word = self._words_l[w]
        if t_low:
            sh = t_low << 1
            word = (word >> sh) << sh
        base = self._occ_w[w]
        inv = ~word & 0xFFFFFFFF
        c0 = (((inv >> 1) & inv) & 0x55555555).bit_count() - t_low
        c1 = (((inv >> 1) & word) & 0x55555555).bit_count()
        c2 = (((word >> 1) & inv) & 0x55555555).bit_count()
        c3 = (((word >> 1) & word) & 0x55555555).bit_count()
        return (base[0] + c0, base[1] + c1, base[2] + c2, base[3] + c3)

    def extend_s(self, ik, is_back: bool):
        """Scalar bwt_extend on an (x0, x1, s) tuple -> tuple of 4 (x0,x1,s)."""
        x0, x1, s = ik
        xnb = x0 if is_back else x1
        xb = x1 if is_back else x0
        tk = self.occ4_s(xnb - 1)
        tl = self.occ4_s(xnb - 1 + s)
        L2 = self._L2_l
        sizes = (tl[0] - tk[0], tl[1] - tk[1], tl[2] - tk[2], tl[3] - tk[3])
        xnb_new = (L2[0] + 1 + tk[0], L2[1] + 1 + tk[1],
                   L2[2] + 1 + tk[2], L2[3] + 1 + tk[3])
        crosses = 1 if (xnb <= self.primary <= xnb + s - 1) else 0
        b3 = xb + crosses
        b2 = b3 + sizes[3]
        b1 = b2 + sizes[2]
        b0 = b1 + sizes[1]
        xb_new = (b0, b1, b2, b3)
        if is_back:
            return tuple((xnb_new[c], xb_new[c], sizes[c]) for c in range(4))
        return tuple((xb_new[c], xnb_new[c], sizes[c]) for c in range(4))

    def bwt_char_s(self, k: int) -> int:
        return (self._words_l[k >> 4] >> (((~k) & 15) << 1)) & 3

    def sa_s(self, k: int) -> int:
        """Scalar bwt_sa walk."""
        add = 0
        mask = self.sa_intv - 1
        while k & mask:
            add += 1
            # inv_psi
            x = k - (1 if k > self.primary else 0)
            c = self.bwt_char_s(x)
            if k == self.primary:
                k = 0
            else:
                k = self._L2_l[c] + self.occ4_s(k)[c]
        return add + self._sa_l[k >> self._sa_shift]

    def bwt_char(self, k):
        """BWT char at $-removed position k (vectorized)."""
        k = np.asarray(k, dtype=np.int64)
        return (self.words[k >> 4] >> (((~k & 15) << 1).astype(np.uint32))) & 3

    def occ4(self, k):
        """occ counts of all 4 bases in bwt[0..k] inclusive, k in [-1, seq_len].
        Returns int64 [..., 4]."""
        k = np.asarray(k, dtype=np.int64)
        scalar = k.ndim == 0
        k = np.atleast_1d(k)
        out = np.zeros(k.shape + (4,), dtype=np.int64)
        full = k == self.seq_len
        out[full] = (self.L2[1:5] - self.L2[0:4])
        mid = (~full) & (k >= 0)
        kk = k[mid] - (k[mid] >= self.primary)
        block = kk >> OCC_SHIFT
        acc = self.occ_cp[block].astype(np.int64)  # [M,4] gather + widen
        w_idx = (kk >> 4) & 7
        t_low = (~kk & 15).astype(np.uint32)  # number of masked-off low bases in partial word
        base_word = block * WORDS_PER_BLOCK
        for j in range(WORDS_PER_BLOCK):
            w = self.words[np.minimum(base_word + j, len(self.words) - 1)]
            sel_full = j < w_idx
            sel_part = j == w_idx
            wm = np.where(sel_part, (w >> (t_low << 1)) << (t_low << 1), w)
            active = sel_full | sel_part
            for c in range(4):
                y = wm.astype(np.uint64)
                t = ((y if c & 2 else ~y) >> 1) & (y if c & 1 else ~y) & np.uint64(0x55555555)
                cnt = popcount64(t)
                if c == 0:
                    cnt = cnt - np.where(sel_part, t_low.astype(np.int64), 0)
                acc[:, c] += np.where(active, cnt, 0)
        out[mid] = acc
        return out[0] if scalar else out

    def occ(self, k, c):
        return self.occ4(k)[..., c]

    def extend(self, ik, is_back: bool):
        """Reference bwt_extend (bwt.c:278-293) on interval rows
        ik = [..., 3] (x0, x1, s). Returns ok [..., 4, 3]."""
        ik = np.asarray(ik, dtype=np.int64)
        # reference indexes x[!is_back]
        xnb = ik[..., 0] if is_back else ik[..., 1]
        xb = ik[..., 1] if is_back else ik[..., 0]
        s = ik[..., 2]
        tk = self.occ4(xnb - 1)
        tl = self.occ4(xnb - 1 + s)
        ok = np.zeros(ik.shape[:-1] + (4, 3), dtype=np.int64)
        nb_axis = 0 if is_back else 1
        b_axis = 1 - nb_axis
        for c in range(4):
            ok[..., c, nb_axis] = self.L2[c] + 1 + tk[..., c]
            ok[..., c, 2] = tl[..., c] - tk[..., c]
        crosses = (xnb <= self.primary) & (xnb + s - 1 >= self.primary)
        ok[..., 3, b_axis] = xb + crosses
        ok[..., 2, b_axis] = ok[..., 3, b_axis] + ok[..., 3, 2]
        ok[..., 1, b_axis] = ok[..., 2, b_axis] + ok[..., 2, 2]
        ok[..., 0, b_axis] = ok[..., 1, b_axis] + ok[..., 1, 2]
        return ok

    def sa(self, k):
        """Text position for rank k (reference bwt_sa walk, bwt.c:87-97)."""
        k = np.asarray(k, dtype=np.int64)
        scalar = k.ndim == 0
        k = np.atleast_1d(k).copy()
        add = np.zeros_like(k)
        mask = self.sa_intv - 1
        active = (k & mask) != 0
        while active.any():
            ka = k[active]
            add[active] += 1
            k[active] = self.inv_psi(ka)
            active = (k & mask) != 0
        res = add + self.sa_samples[k // self.sa_intv]
        return res[0] if scalar else res

    def inv_psi(self, k):
        x = k - (k > self.primary)
        c = self.bwt_char(x)
        o4 = self.occ4(k)
        occs = np.take_along_axis(o4, c[..., None].astype(np.int64), axis=-1)[..., 0]
        x2 = self.L2[c] + occs
        return np.where(k == self.primary, 0, x2)

    def set_intv(self, other: "FMNumpy", c):
        """Reference bwt_set_intv (bwt.h:105): initial 1-base bi-interval; the
        complement-side position comes from the OTHER strand index's L2."""
        c = np.asarray(c, dtype=np.int64)
        x0 = self.L2[c] + 1
        s = self.L2[c + 1] - self.L2[c]
        x1 = other.L2[3 - c] + 1
        return np.stack([x0, x1, s], axis=-1)


def popcount64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    x = x - ((x >> np.uint64(1)) & np.uint64(0x5555555555555555))
    x = (x & np.uint64(0x3333333333333333)) + ((x >> np.uint64(2)) & np.uint64(0x3333333333333333))
    x = (x + (x >> np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    return ((x * np.uint64(0x0101010101010101)) >> np.uint64(56)).astype(np.int64)
