"""setup_s: seconds from the process's start to the measured window's
start (imports, library load and kernel build, traffic synthesis, the
receiver's construction, its capture and the warm-up steps).  Host clock."""


def read(run, ctx):
    return run.setup_s
