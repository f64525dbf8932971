"""Process start to the first timed request or step: imports, the CUDA
context, loading (and, in the first run of a checkout, building) the
kernels, drawing the weights and warming up the cell's own shapes."""


def read(run):
    return run.setup_s
