"""setup_s: seconds from the start of the run to the first call of
the window: data, weights, the program's objects, the kernels' build
(first run of a checkout only) and the warm-up of every shape."""


def read(record):
    return record["setup_s"]
