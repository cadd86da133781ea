"""optimizer_device_ms.train: device ms a train step in the program's
``step.optimizer`` span (the zero fill, the non-finite check, Adam's step
and the skip flag), in the attributed call."""

from benchmark.harness import readers


def read(record):
    return readers.span_ms(record, "train", "step.optimizer", "engine.step")
