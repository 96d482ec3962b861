"""The seeder's fused tables built at set-up (`FMPair.from_index`, the
span `setup.seeder_tables`, stage_report()), in seconds."""


def read(ctx):
    return ctx["stages"].get("setup.seeder_tables")
