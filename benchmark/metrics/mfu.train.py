"""mfu.train: the model's FLOP for the window's completed work (counted
from the reference network's convs at the cell's shapes) over the
window's time and the precision's peak, in %."""

from benchmark.harness import readers


def read(record):
    return readers.mfu(record, "train")
