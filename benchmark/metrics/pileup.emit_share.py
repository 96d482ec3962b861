"""Pileup's `emit` stage (engine.STAGES) over the window, in percent."""


def read(ctx):
    return 100.0 * ctx["stages"]["emit"] / ctx["wall"]
