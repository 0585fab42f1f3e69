"""The median time to result (reset, run to the end and read-back) over
every run of the window, in ms."""
import statistics


def read(ctx):
    return 1e3 * statistics.median(r["total_s"] for r in ctx.runs)
