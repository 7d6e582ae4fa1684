"""Process start to the first timed request: imports, the CUDA context,
kernels from the build cache (or their build), weights, inputs, warm-up."""


def read(run):
    return run.setup_s
