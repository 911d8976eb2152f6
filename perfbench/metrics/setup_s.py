"""Set-up: from the process's start to the window's opening (loading,
drawing the weights, building the kernels where none are built, warming
up, the cell's own cache fill)."""


def read(record):
    return record.setup_s
