"""The device's idle share of the traced window, in %: one less the union
of the device events' intervals over the wall, resets included."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr["busy_s"] is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
