"""The until-loop's CUDA-graph captures (``until.captures``) over the
window, a run: a reset that makes the loop capture anew shows here."""


def read(ctx):
    return ctx.counters["captures"] / len(ctx.runs)
