"""The longest chunk's wall in the window, in seconds: a stall detector."""


def read(ctx):
    return max(ctx["chunk_s"]) if ctx["chunk_s"] else None
