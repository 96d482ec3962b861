"""Pileup's `count` stage (engine.STAGES: staging, copies, K9) over the
window, in percent."""


def read(ctx):
    return 100.0 * ctx["stages"]["count"] / ctx["wall"]
