"""kxk_wgrad_device_ms.train: device ms a train step in the program's
``kxk.grad_weight`` span (the k x k convs' grad-weight and its permutes),
in the attributed call."""

from benchmark.harness import readers


def read(record):
    return readers.span_ms(record, "train", "kxk.grad_weight", "engine.step")
