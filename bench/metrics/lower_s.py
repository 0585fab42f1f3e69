"""Host seconds of building the system: the description and the engine's
constructor (the lowering)."""


def read(ctx):
    return ctx.lower_s
