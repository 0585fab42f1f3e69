"""The card's allocations a run: the caching allocator's ``cudaMalloc``s
(``num_device_alloc``) over the window, a run.  Above 0 where a reset
builds its state at new addresses after the device loop's capture has
emptied the allocator's cache: the tail of a run's time."""


def read(ctx):
    if "device_allocs" not in ctx.counters:
        return None
    return ctx.counters["device_allocs"] / len(ctx.runs)
