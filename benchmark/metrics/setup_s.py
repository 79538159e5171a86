"""setup_s: seconds from the process's start to the window's start
(imports, kernel libraries, weights or train state from the seed, graph
capture, warm-up of the cell's shapes; training also its first steps)."""


def read(run):
    return run.setup_s
