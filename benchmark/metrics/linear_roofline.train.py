"""linear_roofline.train: the transformer's linears' share of their roofline
in the attributed call, in %: the least time of the reference network's
linears and matmuls (forward and both operands' gradients; a transposed
conv whose kernel equals its stride is one) over the device time of the
program's ``linear.forward`` and ``linear.backward`` spans."""

from benchmark.harness import span_share


def read(record):
    return span_share.roofline(record, "train", "linear")
