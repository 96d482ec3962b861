"""The native C++ engine's `native` stage (stage_report()) over the
window, in percent."""


def read(ctx):
    s = ctx["stages"].get("native")
    return None if s is None else 100.0 * s / ctx["wall"]
