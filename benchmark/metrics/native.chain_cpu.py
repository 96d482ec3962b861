"""Seeding and chaining in the C++ engine (the thread-seconds of the slots
`native.cpu.seed`, `chain(+sa)` and `chain_flt`, stage_report(); the SA
walks, slot `sa_walk`, run inside `chain(+sa)` and are counted there
once; `native.sa_walk_cpu` reads them alone) over its threads' busy time,
in percent. The slots run only while a torch.profiler records: the traced
run."""

SLOTS = ("seed", "chain(+sa)", "chain_flt")


def read(ctx):
    st = ctx["stages"]
    if not st.get("native.busy_cpu") or \
            "native.cpu.chain(+sa)" not in st:
        return None
    return 100.0 * sum(st.get("native.cpu." + s, 0.0) for s in SLOTS) \
        / st["native.busy_cpu"]
