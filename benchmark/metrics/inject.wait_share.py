"""The hybrid seeder's host blocked on the card (`inject.wait`, each wait
on the seeder's stream) over the whole `inject` stage (stage_report()), in
percent."""


def read(ctx):
    st = ctx["stages"]
    if not st.get("inject") or "inject.wait" not in st:
        return None
    return 100.0 * st["inject.wait"] / st["inject"]
