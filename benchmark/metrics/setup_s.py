"""setup_s: from the start of the process to the start of the window:
imports, the problem's generation, for a solve mix the structure and the
engine, the warm-up requests and, on a checkout's first run, the build of
the port's kernels."""


def read(run):
    return run.setup_s
