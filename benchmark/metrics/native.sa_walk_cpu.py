"""The SA walks in the C++ engine (the thread-seconds of the slot
`native.cpu.sa_walk`, stage_report(), which runs inside `chain(+sa)` and
so inside `native.chain_cpu`) over its threads' busy time, in percent;
the traced run only."""


def read(ctx):
    st = ctx["stages"]
    if not st.get("native.busy_cpu") or "native.cpu.sa_walk" not in st:
        return None
    return 100.0 * st["native.cpu.sa_walk"] / st["native.busy_cpu"]
