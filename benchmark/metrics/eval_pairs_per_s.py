"""eval_pairs_per_s: frame pairs evaluated per second through TrainingEngine.eval_epoch, all the work of the window over all its time."""

from benchmark.harness import readers


def read(record):
    return readers.rate(record, "eval")
