"""The least time the card could take for a kernel's work, and the shares
of it that the per-layer metrics report.

Provenance: a frozen copy of chip_smoke.py's bound arithmetic (`bound`, its
peaks, and the byte counts of K3's floor, K4's one-sample floor and K9's
fused window count), fed from what a run of the benchmark counts: the bases
of the lanes the seeder took, the rows and jobs the SA walk took
(`stage_report()`'s sa_rows and sa_jobs), the data and positions a pileup
window counted.
"""
# the card's published peaks (NVIDIA H100 SXM data sheet): 3.35 TB/s of
# device memory, 67 TFLOP/s of float32 outside the tensor cores; the kernels
# do int32 arithmetic, for which the sheet gives no rate: an FMA counts two
# operations and an SM has half as many int32 lanes as float32 lanes, so the
# integer rate is a quarter of that figure
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12 / 4


def bound_s(n_bytes: float, n_ops: float) -> float:
    """Seconds to move n_bytes once and to do n_ops integer operations,
    whichever is longer."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / INT_OPS_PER_S)


def k3_floor(lane_bases: int, row_bytes: int) -> float:
    """K3 (smem_seed), a floor: every base of a lane is extended over at
    least once, an extension gathers two rows of the fused table, the lane's
    base is read (int32), and 40 integer operations a base."""
    return bound_s(lane_bases * (2 * row_bytes + 4), 40 * lane_bases)


def k4_floor(rows: int, jobs: int) -> float:
    """K4's interval entry (sa_walk), the one-sample floor: each row's
    strand, x0, kmax and offset read once (int64), and each job's SA sample
    read and its position written (int64); no walk step counted."""
    return bound_s(rows * 32 + jobs * 16, 0)


def k9_bound(data: int, positions: int) -> float:
    """K9's fused window count (pileup_count): 6 bytes a datum in (int32
    site, uint8 code, bool pass), 11 int32 words a window position out."""
    return bound_s(6 * data + 44 * positions, 0)


def kernel_seconds(ctx, name: str):
    """Seconds the traced window's kernels whose names hold `name` ran, or
    None where the run was not traced or ran none."""
    tr = ctx.get("trace")
    if not tr:
        return None
    s = sum(v for k, v in tr["kernels"].items() if name in k)
    return s or None


def share(bound: float, seconds):
    """The bound over the time taken, in percent; None without a time."""
    return None if not seconds else 100.0 * bound / seconds
