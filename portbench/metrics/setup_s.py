"""setup_s: seconds from the harness's start (before torch is imported)
to the window's open: loading the libraries and the program, building
the kernels where none are built, the load policy, the warm engines and
the warm-up of every shape the mix sends."""

SOURCE = "host_clock"


def read(run):
    return run.setup_s
