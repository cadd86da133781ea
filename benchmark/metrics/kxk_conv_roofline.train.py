"""kxk_conv_roofline.train: the k x k conv kernels' share of their roofline
in the attributed call, in %: the least time of the reference network's
groups-1, stride-1, k > 1 convs' forward and grad-input work over the
device time of the program's ``kxk.forward`` and ``kxk.grad_input``
spans."""

from benchmark.harness import readers


def read(record):
    return readers.kxk_roofline(record, "train")
