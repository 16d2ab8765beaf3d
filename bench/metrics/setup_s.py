"""setup_s: seconds from the process's start to the window's: imports,
loading (and in a checkout's first run, building) the kernels, making the
weights on the card, and warming the cell's shapes (host clock)."""


def read(run):
    return run.setup_s
