"""setup_s: process start to the first timed step: imports, the kernels'
build (from the port's cache after a checkout's first run), env or learner,
graph captures and warm-up."""


def read(ctx):
    return ctx["setup_seconds"]
