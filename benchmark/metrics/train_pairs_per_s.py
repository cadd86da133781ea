"""train_pairs_per_s: frame pairs trained per second through TrainingEngine.train_epoch, all the work of the window over all its time."""

from benchmark.harness import readers


def read(record):
    return readers.rate(record, "train")
