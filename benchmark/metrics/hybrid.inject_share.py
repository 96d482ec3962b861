"""The hybrid seeder's `inject` stage (stage_report()) over the window, in
percent; in SE it runs in the injector thread beside `native`."""


def read(ctx):
    s = ctx["stages"].get("inject")
    return None if s is None else 100.0 * s / ctx["wall"]
