"""setup_s (host clock): seconds from the start of the process to the start
of the window: imports, inputs and weights made from the seed, the
program built, the kernels' build where the checkout has none, and the
warm-up calls or steps (a training cell's checked steps among them)."""


def read(run):
    return run["setup_s"]
