"""device_idle.train: the device's idle share of the profiled span, in %."""

from benchmark.harness import readers


def read(record):
    return readers.device_idle(record, "train")
