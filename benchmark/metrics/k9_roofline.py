"""K9's fused window count (pileup_count_kernel) against 6 B a datum in
and 44 B a position out over 3.35 TB/s, from its profiler time, in
percent."""
from benchmark.bounds import k9_bound, kernel_seconds, share


def read(ctx):
    return share(k9_bound(ctx["stages"]["data"], ctx["positions"]),
                 kernel_seconds(ctx, "pileup_count_kernel"))
