"""1 minus the union of the card's activity (kernels, copies, memsets) in
the traced window over the window, in percent."""


def read(ctx):
    tr = ctx.get("trace")
    return None if not tr else 100.0 * (1 - tr["busy_s"] / tr["window_s"])
