"""The C++ engine's worker threads busy inside their work-stealing loops
(`native.busy_cpu`, stage_report()) over the thread count times the
parallel phases' wall (`native.phase.regions+sam`, `regions`, `pair`), in
percent."""

PARALLEL = ("regions+sam", "regions", "pair")


def read(ctx):
    st = ctx["stages"]
    wall = sum(st.get("native.phase." + p, 0.0) for p in PARALLEL)
    if not wall or not st.get("native.threads"):
        return None
    return 100.0 * st["native.busy_cpu"] / (st["native.threads"] * wall)
