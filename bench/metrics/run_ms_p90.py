"""The 90th percentile of the time to result (reset, run to the end and
read-back) over every run of the window, in ms, as
``statistics.quantiles(n=10)`` puts it: the tail a run pays for the device
loop's capture after each reset (the capture empties the card's allocator
cache, so the next reset allocates anew)."""
import statistics


def read(ctx):
    times = [r["total_s"] for r in ctx.runs]
    if len(times) < 2:
        return 1e3 * times[0]
    return 1e3 * statistics.quantiles(times, n=10)[-1]
