"""The C++ engine's calls (the port's span `native.call`, stage_report())
over the window, in percent."""


def read(ctx):
    s = ctx["stages"].get("native.call")
    return None if s is None else 100.0 * s / ctx["wall"]
