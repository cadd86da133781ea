"""loss_device_ms.eval: device ms an eval batch in the program's
``eval.loss`` span (the geometric consistency loss chain), in the
attributed call."""

from benchmark.harness import readers


def read(record):
    return readers.span_ms(record, "eval", "eval.loss", "eval.batch")
