"""The hybrid seeder's copies as the host issues them, the reads to the
card from pageable memory (`inject.to_card`) and the pinned buffers
allocated and filled (`inject.pin`), over the whole `inject` stage
(stage_report()), in percent."""


def read(ctx):
    st = ctx["stages"]
    if not st.get("inject") or "inject.to_card" not in st:
        return None
    return 100.0 * (st["inject.to_card"] + st.get("inject.pin", 0.0)) \
        / st["inject"]
