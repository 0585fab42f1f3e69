"""The until-loop's host reads of the card (``until.host_syncs``) over
the window, a run."""


def read(ctx):
    return ctx.counters["host_syncs"] / len(ctx.runs)
