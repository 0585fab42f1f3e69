"""Process start to the end of the warm run: import, the kernels loaded
(built, in a checkout's first run), the system lowered and one run."""


def read(ctx):
    return ctx.setup_s
