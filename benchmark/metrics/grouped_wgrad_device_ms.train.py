"""grouped_wgrad_device_ms.train: device ms a train step in the program's
``grouped.grad_weight`` span (the grouped 3x3 convs' grad-weight kernel and
its reduce), in the attributed call."""

from benchmark.harness import readers


def read(record):
    return readers.span_ms(record, "train", "grouped.grad_weight",
                           "engine.step")
