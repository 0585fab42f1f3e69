"""``granule_cycle``'s device time per simulated cycle of the traced
runs, in us: every ``granule_cycle`` entry of the trace's ``device_ops``
(every variant; the until-loop's gated launches after the stop
included) over the cycles those runs simulated."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.get("cycles"):
        return None
    steps = [secs for name, secs in tr["device_ops"] if "granule_cycle" in name]
    if not steps:
        return None
    return 1e6 * sum(steps) / tr["cycles"]
