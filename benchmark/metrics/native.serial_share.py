"""The C++ engine's serial phases, PE's insert-size statistics and the SAM
text joined into one buffer (`native.phase.pestat` and
`native.phase.concat`, stage_report()), over the window, in percent."""


def read(ctx):
    st = ctx["stages"]
    if "native.phase.concat" not in st:
        return None
    return 100.0 * (st.get("native.phase.pestat", 0.0)
                    + st["native.phase.concat"]) / ctx["wall"]
