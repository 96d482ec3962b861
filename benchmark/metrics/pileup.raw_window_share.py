"""Pileup's windows that the `device` engine's C++ walk over raw BAM records
decoded and emitted (engine.STAGES `raw_windows`) over the windows that held
data (`windows`), in percent; nothing where the program counts no such
windows."""


def read(ctx):
    st = ctx["stages"]
    if "raw_windows" not in st or not st["windows"]:
        return None
    return 100.0 * st["raw_windows"] / st["windows"]
