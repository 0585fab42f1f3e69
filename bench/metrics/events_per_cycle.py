"""Device events inside the benchmark's ``run`` spans of the traced
window, a simulated cycle."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr["run_events"] or not tr["cycles"]:
        return None
    return tr["run_events"] / tr["cycles"]
