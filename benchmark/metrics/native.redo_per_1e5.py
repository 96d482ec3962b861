"""Reads the C++ engine hands back for Python to align again
(`native.redo_reads`, stage_report()) per 10^5 reads it was given
(`native.reads`) in the window."""


def read(ctx):
    st = ctx["stages"]
    if not st.get("native.reads") or "native.redo_reads" not in st:
        return None
    return 1e5 * st["native.redo_reads"] / st["native.reads"]
