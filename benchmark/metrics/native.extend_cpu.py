"""Extension in the C++ engine (the thread-seconds of the slot
`native.cpu.extend`, stage_report()) over its threads' busy time, in
percent; the traced run only."""


def read(ctx):
    st = ctx["stages"]
    if not st.get("native.busy_cpu") or "native.cpu.extend" not in st:
        return None
    return 100.0 * st["native.cpu.extend"] / st["native.busy_cpu"]
