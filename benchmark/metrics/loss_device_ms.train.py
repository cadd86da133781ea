"""loss_device_ms.train: device ms a train step in the program's
``step.loss`` span (the geometric consistency loss chain's forward), in
the attributed call."""

from benchmark.harness import readers


def read(record):
    return readers.span_ms(record, "train", "step.loss", "engine.step")
