"""K4's interval entry (sa_walk_kernel) against its one-sample floor from
the rows and jobs handed to it, from its profiler time, in percent."""
from benchmark.bounds import k4_floor, kernel_seconds, share


def read(ctx):
    st = ctx["stages"]
    return share(k4_floor(st["sa_rows"], st["sa_jobs"]),
                 kernel_seconds(ctx, "sa_walk_kernel"))
