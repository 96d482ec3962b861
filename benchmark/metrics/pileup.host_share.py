"""Pileup's host stages (engine.STAGES `open`, `decode`, `emit`) over the
window, in percent."""


def read(ctx):
    st = ctx["stages"]
    return 100.0 * (st["open"] + st["decode"] + st["emit"]) / ctx["wall"]
