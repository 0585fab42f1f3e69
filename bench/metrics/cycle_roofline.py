"""The whole simulated cycle against its roofline, in %: the least time of
the traced runs (their per-epoch byte count, ``epoch_bytes`` of the
configuration, at the peak memory rate) over the device's busy time inside
the ``run`` spans, every device operation of the cycle included."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr["run_busy_s"] or tr["bytes"] is None:
        return None
    least_s = tr["bytes"] / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / tr["run_busy_s"]
