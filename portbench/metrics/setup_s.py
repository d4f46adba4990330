"""setup_s: process start to the window's opening (host clock): imports,
weights, the kernels' load (their build in a checkout's first run), the
scene pool and the warm-up."""


def read(run):
    return run.setup_s
