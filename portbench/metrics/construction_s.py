"""construction_s: the program's own span of Graph500 step 2
(``BuiltGraph.construction_s``: CSR, degree sort, heavy core, weights)."""


def read(ctx):
    return ctx.construction_s
