"""Simulated core-cycles of every run finished in the window (cores x
cycles to the end), over the window's wall seconds, reset and read-back
included."""


def read(ctx):
    cycles = [r["cycles"] for r in ctx.runs]
    if ctx.cores is None or None in cycles:
        return None
    return ctx.cores * sum(cycles) / ctx.window_s
