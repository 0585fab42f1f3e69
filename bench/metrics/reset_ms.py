"""The session layer: ms of ``Simulation.reset`` and the result read a
run, each ending in a synchronize, averaged over the window's runs."""


def read(ctx):
    return 1e3 * sum(r["reset_s"] + r["read_s"] for r in ctx.runs) / len(ctx.runs)
