"""The native stage's Python around the C++ calls (`native` less
`native.call`, stage_report(): marshalling the reads, decoding the SAM and
aligning again the reads the C++ engine hands back) over the window, in
percent."""


def read(ctx):
    st = ctx["stages"]
    if "native" not in st or "native.call" not in st:
        return None
    return 100.0 * (st["native"] - st["native.call"]) / ctx["wall"]
