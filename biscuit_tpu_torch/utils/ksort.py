"""Behavioral emulation of the reference's ksort.h introsort.

The reference sorts chains and regions with ks_introsort (ksort.h:184-234),
whose comparators take only a strict less-than — so the relative order of
EQUAL keys is decided by the algorithm's partition/swap pattern, not by
input order (it is not a stable sort). Downstream logic is sensitive to
that order: mem_chain_flt keeps the *first* shadowed chain (memchain.c:449)
and sub-score bookkeeping reads adjacent pairs, so byte-for-byte SAM parity
requires reproducing the exact element order, ties included.

This module reimplements the introsort control flow (median-of-three
pivot biased one past the midpoint, pivot parked at the right end,
explicit stack with segments <= 16 left for a final insertion pass, and a
combsort fallback when the depth budget is exhausted) over Python lists.
Only the ordering semantics are mirrored; see ksort.h for the original.

Copy of biscuit_tpu/utils/ksort.py: the code is the source's, so that the port
imports nothing of the JAX package; tests/test_torch_engine.py holds the
copy to its source.
"""


def _insertsort(a, lo, hi, lt):
    for i in range(lo + 1, hi):
        j = i
        while j > lo and lt(a[j], a[j - 1]):
            a[j], a[j - 1] = a[j - 1], a[j]
            j -= 1


def _combsort(a, lo, n, lt):
    shrink = 1.2473309501039786540366528676643
    gap = n
    while True:
        if gap > 2:
            gap = int(gap / shrink)
            if gap in (9, 10):
                gap = 11
        do_swap = False
        for i in range(lo, lo + n - gap):
            j = i + gap
            if lt(a[j], a[i]):
                a[i], a[j] = a[j], a[i]
                do_swap = True
        if not (do_swap or gap > 2):
            break
    if gap != 1:
        _insertsort(a, lo, lo + n, lt)


def introsort(a, lt):
    """Sort list `a` in place with ksort.h ks_introsort element order."""
    n = len(a)
    if n < 1:
        return
    if n == 2:
        if lt(a[1], a[0]):
            a[0], a[1] = a[1], a[0]
        return
    d = 2
    while (1 << d) < n:
        d += 1
    stack = []
    s, t = 0, n - 1
    d <<= 1
    while True:
        if s < t:
            d -= 1
            if d == 0:
                _combsort(a, s, t - s + 1, lt)
                t = s
                continue
            i, j = s, t
            k = i + ((j - i) >> 1) + 1
            if lt(a[k], a[i]):
                if lt(a[k], a[j]):
                    k = j
            else:
                k = i if lt(a[j], a[i]) else j
            rp = a[k]
            if k != t:
                a[k], a[t] = a[t], a[k]
            while True:
                i += 1
                while lt(a[i], rp):
                    i += 1
                j -= 1
                while i <= j and lt(rp, a[j]):
                    j -= 1
                if j <= i:
                    break
                a[i], a[j] = a[j], a[i]
            a[i], a[t] = a[t], a[i]
            if i - s > t - i:
                if i - s > 16:
                    stack.append((s, i - 1, d))
                s = i + 1 if t - i > 16 else t
            else:
                if t - i > 16:
                    stack.append((i + 1, t, d))
                t = i - 1 if i - s > 16 else s
        else:
            if not stack:
                _insertsort(a, 0, n, lt)
                return
            s, t, d = stack.pop()
