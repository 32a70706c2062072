"""setup_s: seconds from the process's start to the window's start:
imports, the card's context, the inputs, the program's build, its plan and
the warm-up searches (and, in a checkout's first run, the kernels' build)."""


def read(ctx):
    return ctx.setup_s
