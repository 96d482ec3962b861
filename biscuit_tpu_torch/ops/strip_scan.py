"""What the warp-per-lane DP kernels (K1 sw_extend, K7 sw_local, K2
sw_global) share on the Python side: the strip widths they are compiled for,
the instance a query width runs, and the algebra of their F scans as torch
functions that the CPU tests hold to the serial recurrences (the kernels
themselves run only on the card).

In each kernel a warp of 32 threads owns one alignment and thread l holds
the C consecutive query columns [l * C, l * C + C) of the DP row in
registers; a query wider than 32 * max(STRIP_WIDTHS) runs the kernel's wide
instance, which keeps strips of ceil(Lq / 32) columns in shared memory
(kernels/strip.cuh). In K1 and K7 F of a row, F(0) = 0, F(j) = max(F(j-1) - e_ins,
tF(j-1)) with tF >= 0, does not depend on the row's own H, so it is the
max-plus prefix scan F(j) = max(0, max_{k<j} tF(k) - (j-1-k) * e_ins). In K2
F is not clamped at 0 and starts from a ramped sentinel: see
`global_f_row_strips`.
"""
import torch

WARP = 32
# the instances of C in kernels/sw_extend.cu, kernels/sw_local.cu and
# kernels/sw_global.cu (FOR_EACH_C there)
STRIP_WIDTHS = (2, 4, 5, 6, 8, 12, 16)
# the strip width that stands for the wide instance
WIDE = 0
# the widest query any instance takes: the F scans add (Lq - 1) * e_ins to
# values as low as VERYNEG in int32, and up to here, with e_ins up to 256,
# nothing comes near -2^31
MAX_QUERY_WIDTH = 1 << 20

# global alignment's sentinel, the scalar oracle's (ops/sw.py:20). It is
# ramped (f0 - j*e_ins, h1_first - ...) and its exact value reaches the
# direction bits of in-band sentinel cells, so every path uses it as is
MINUS_INF = -0x40000000
VERYNEG = -0x48000000     # below any ramped MINUS_INF; loses every max


def strip_width(Lq: int) -> int:
    """The smallest compiled strip width C with 32 * C >= Lq, WIDE for a
    query wider than them all; raises ValueError for a query width no
    instance takes."""
    if not 0 <= Lq <= MAX_QUERY_WIDTH:
        raise ValueError(f"Lq={Lq}: the kernel takes query widths up to "
                         f"{MAX_QUERY_WIDTH}")
    for c in STRIP_WIDTHS:
        if WARP * c >= Lq:
            return c
    return WIDE


def wide_scratch(lib, fn: str, C: int, B: int, Lq: int, dev):
    """The device memory the wide instance needs for B lanes of width Lq:
    None for a compiled width, and while a lane's row fits shared memory
    (`fn` of the kernel's library says how many words a lane need)."""
    if C != WIDE:
        return None
    words = int(getattr(lib, fn)(Lq))
    if words == 0:
        return None
    return torch.empty((B, words), dtype=torch.int32, device=dev)


def kernel_codes(query: torch.Tensor, target: torch.Tensor):
    """The two code arrays as the kernels read them: both uint8 or both
    int32, contiguous, lane-major ([B, L], a lane's row contiguous: a strip
    is a run of one row). Arrays that already are so pass through untouched;
    anything else is cast to int32."""
    ok = (torch.uint8, torch.int32)
    if query.dtype != target.dtype or query.dtype not in ok:
        query, target = query.to(torch.int32), target.to(torch.int32)
    return query.contiguous(), target.contiguous()


def f_row_strips(tF: torch.Tensor, e_ins: int, C: int) -> torch.Tensor:
    """F of one DP row from tF [B, Lq] (int32, >= 0), step by step as a warp
    computes it: each of 32 threads scans its strip of C columns for the
    carry it hands on, five shift-and-max steps (distances 1, 2, 4, 8, 16,
    as __shfl_up_sync) combine the carries, each decayed by the columns it
    crossed, and a second pass over the strip applies the carry that came in.
    Returns F [B, Lq]. Used by no caller on the main path."""
    B, Lq = tF.shape
    if WARP * C < Lq:
        raise ValueError(f"Lq={Lq} does not fit 32 strips of {C}")
    t = torch.zeros((B, WARP * C), dtype=tF.dtype)
    t[:, :Lq] = tF
    t = t.reshape(B, WARP, C)
    # pass 1: g[l] = F at the column after strip l if nothing came from the
    # left of the strip
    g = torch.zeros((B, WARP), dtype=tF.dtype)
    for k in range(C):
        g = torch.maximum(g - e_ins, t[:, :, k])
    # the carries combined across the warp (an inclusive scan)
    v = g
    d = 1
    while d < WARP:
        u = torch.zeros_like(v)
        u[:, d:] = v[:, :-d] - d * C * e_ins
        v = torch.where(torch.arange(WARP) >= d, torch.maximum(v, u), v)
        d <<= 1
    # F at each strip's first column: the carry of the strip to its left
    f = torch.zeros_like(v)
    f[:, 1:] = v[:, :-1]
    # pass 2
    F = torch.empty_like(t)
    for k in range(C):
        F[:, :, k] = f
        f = torch.maximum(f - e_ins, t[:, :, k])
    return F.reshape(B, WARP * C)[:, :Lq]


def global_f_row_strips(M: torch.Tensor, beg: torch.Tensor, end: torch.Tensor,
                        oe_ins: int, e_ins: int, C: int) -> torch.Tensor:
    """F of one row of the global DP from M [B, Lq] (int32) and each lane's
    band [beg, end) ([B] int32), step by step as a warp of K2 computes it.
    The recurrence F(beg) = MINUS_INF, F(j+1) = max(F(j) - e_ins,
    M(j) - oe_ins) has no clamp, and reads only M, so with
    b(k) = M(k) - oe_ins + k * e_ins inside the band and VERYNEG outside it
    F(j) = max(MINUS_INF - (j - beg) * e_ins, max_{k<j} b(k) - (j-1) * e_ins):
    each of 32 threads takes the maximum of b over its strip of C columns,
    five shift-and-max steps (distances 1, 2, 4, 8, 16, as __shfl_up_sync)
    make the prefix maximum over the strips, and a second pass over the
    strip applies it. All in int32, as the kernel: b is at least VERYNEG and
    the largest term added or taken off is (32 * C - 1) * e_ins, so for 512
    columns and e_ins up to 6 nothing goes below -0x48000000 - 3066, more
    than 9 * 10^8 above -2^31. Returns F [B, Lq], exact inside the band (the
    cells outside it are never used). Used by no caller on the main path."""
    B, Lq = M.shape
    if WARP * C < Lq:
        raise ValueError(f"Lq={Lq} does not fit 32 strips of {C}")
    i32 = torch.int32
    j = torch.arange(WARP * C, dtype=i32)[None, :]
    m = torch.zeros((B, WARP * C), dtype=i32)
    m[:, :Lq] = M
    inb = (j >= beg[:, None]) & (j < end[:, None])
    b = torch.where(inb, m - oe_ins + j * e_ins, VERYNEG).to(i32)
    b = b.reshape(B, WARP, C)
    # pass 1: the strip's maximum
    g = torch.full((B, WARP), VERYNEG, dtype=i32)
    for k in range(C):
        g = torch.maximum(g, b[:, :, k])
    # the prefix maximum over the strips (an inclusive scan)
    v = g
    d = 1
    while d < WARP:
        u = torch.full_like(v, VERYNEG)
        u[:, d:] = v[:, :-d]
        v = torch.where(torch.arange(WARP) >= d, torch.maximum(v, u), v)
        d <<= 1
    # over the columns left of each strip
    run = torch.full_like(v, VERYNEG)
    run[:, 1:] = v[:, :-1]
    # pass 2
    jj = j.reshape(1, WARP, C)
    F = torch.empty_like(b)
    for k in range(C):
        F[:, :, k] = torch.maximum(
            MINUS_INF - (jj[:, :, k] - beg[:, None]) * e_ins,
            run - (jj[:, :, k] - 1) * e_ins)
        run = torch.maximum(run, b[:, :, k])
    return F.reshape(B, WARP * C)[:, :Lq]
