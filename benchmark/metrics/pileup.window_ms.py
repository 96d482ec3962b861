"""Milliseconds a window with data costs pileup: its `decode`, `count` and
`emit` stages (engine.STAGES) over the windows that held data (`windows`);
nothing where no window held data. `open` is a call's, not a window's."""


def read(ctx):
    st = ctx["stages"]
    if not st["windows"]:
        return None
    return 1000.0 * (st["decode"] + st["count"] + st["emit"]) / st["windows"]
