"""What the warp-per-lane DP kernels (K1 sw_extend, K7 sw_local) share on
the Python side: the strip widths they are compiled for, and the algebra of
their F scan as a torch function that the CPU tests hold to the serial
recurrence (the kernels themselves run only on the card).

In both kernels a warp of 32 threads owns one alignment and thread l holds
the C consecutive query columns [l * C, l * C + C) of the DP row in
registers. F of a row, F(0) = 0, F(j) = max(F(j-1) - e_ins, tF(j-1)) with
tF >= 0, does not depend on the row's own H, so it is the max-plus prefix
scan F(j) = max(0, max_{k<j} tF(k) - (j-1-k) * e_ins).
"""
import torch

WARP = 32
# the instances of C in kernels/sw_extend.cu and kernels/sw_local.cu
# (FOR_EACH_C there): query widths up to 32 * 16 = 512
STRIP_WIDTHS = (2, 4, 5, 6, 8, 12, 16)


def strip_width(Lq: int) -> int:
    """The smallest compiled strip width C with 32 * C >= Lq; raises
    ValueError for a query width no instance takes."""
    for c in STRIP_WIDTHS:
        if WARP * c >= Lq:
            return c
    raise ValueError(f"Lq={Lq}: the kernel takes query widths up to "
                     f"{WARP * STRIP_WIDTHS[-1]}")


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
