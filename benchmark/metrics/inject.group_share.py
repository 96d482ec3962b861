"""The hybrid seeder's bookkeeping around its kernels, the rows grouped by
lane with their prefix sums (`inject.group`) and the host arrays handed
to the C++ engine (`inject.arrays`), over the whole `inject` stage
(stage_report()), in percent."""


def read(ctx):
    st = ctx["stages"]
    if not st.get("inject") or "inject.group" not in st:
        return None
    return 100.0 * (st["inject.group"] + st.get("inject.arrays", 0.0)) \
        / st["inject"]
