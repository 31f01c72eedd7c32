"""setup_s: process start to the first timed request (s): imports, CUDA
initialisation, the kernel library's load (its build on a checkout's first
run), the operator, the port's analysis, warm-up."""


def read(run):
    return run.setup_s
