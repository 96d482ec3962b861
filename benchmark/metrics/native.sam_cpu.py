"""Region merging, pairing and SAM in the C++ engine over its threads'
busy time, in percent; the traced run only. SE: the slots
`native.cpu.merge_regions` and `worker2(sam)`; PE: the `pair` phase's busy
time (`native.busy.pair`: pairing, mate rescue, SAM) and
`merge_regions` (stage_report())."""


def read(ctx):
    st = ctx["stages"]
    if not st.get("native.busy_cpu") or \
            "native.cpu.merge_regions" not in st:
        return None
    return 100.0 * (st["native.cpu.merge_regions"]
                    + st.get("native.cpu.worker2(sam)", 0.0)
                    + st.get("native.busy.pair", 0.0)) / st["native.busy_cpu"]
