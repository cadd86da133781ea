"""attention_roofline.train: the attention's share of its roofline in the
attributed call, in %: the least time of the reference network's
attentions (forward and backward, flash-style bytes) over the device time
of the program's ``attention.forward`` and ``attention.backward`` spans."""

from benchmark.harness import span_share


def read(record):
    return span_share.roofline(record, "train", "attention")
