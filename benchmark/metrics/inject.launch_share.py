"""The hybrid seeder's kernel calls as the host sees them, the K3 sweep
loop with its lanes' conversion (`inject.seed`) and K4's interval entry
(`inject.sa`), over the whole `inject` stage (stage_report()), in
percent."""


def read(ctx):
    st = ctx["stages"]
    if not st.get("inject") or "inject.seed" not in st:
        return None
    return 100.0 * (st["inject.seed"] + st.get("inject.sa", 0.0)) \
        / st["inject"]
