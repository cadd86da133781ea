"""Training: the port of ``consistent_depth_tpu/training`` (the train step
and the optimizers in this slice).

The JAX package's host-side data helpers import no JAX, so they are its
own, re-exported here: the padded pair-batch iterator and the frame range
and pair sampling.
"""

from consistent_depth_tpu.data.video_dataset import (  # noqa: F401
    PairBatchIterator)
from consistent_depth_tpu.utils import frame_range, frame_sampling  # noqa: F401

from .engine import TrainingEngine, gather_batch  # noqa: F401
from .optimizer import create as create_optimizer  # noqa: F401
