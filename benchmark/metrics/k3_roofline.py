"""K3 (smem_seed_kernel) against its floor of two table rows a lane base,
from its profiler time in the traced window, in percent."""
from benchmark.bounds import k3_floor, kernel_seconds, share


def read(ctx):
    return share(k3_floor(ctx["lane_bases"], ctx["row_bytes"]),
                 kernel_seconds(ctx, "smem_seed_kernel"))
