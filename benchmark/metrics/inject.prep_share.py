"""The reads' preparation for the seeder on the host, adapter clipping
(`clip`) and the lane keys and padded reads (`inject.lanes`,
stage_report()), over the window, in percent."""


def read(ctx):
    st = ctx["stages"]
    if "clip" not in st or "inject.lanes" not in st:
        return None
    return 100.0 * (st["clip"] + st["inject.lanes"]) / ctx["wall"]
