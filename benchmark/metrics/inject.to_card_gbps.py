"""The rate of the hybrid seeder's copies to the card from pageable
memory as the host sees them: the bytes copied (`inject.pageable_bytes`)
over the span that issues them (`inject.to_card`, stage_report()), in
GB/s."""


def read(ctx):
    st = ctx["stages"]
    if not st.get("inject.to_card") or not st.get("inject.pageable_bytes"):
        return None
    return st["inject.pageable_bytes"] / st["inject.to_card"] / 1e9
