"""Training: the port of ``consistent_depth_tpu/training`` (the train step
and the optimizers in this slice), with the host-side helpers it draws on:
the padded pair-batch iterator and the frame range and pair sampling (the
port's own copies, ``data.video_dataset`` and ``utils``).
"""

from ..data.video_dataset import PairBatchIterator  # noqa: F401
from ..utils import frame_range, frame_sampling  # noqa: F401
from .engine import TrainingEngine, gather_batch  # noqa: F401
from .optimizer import create as create_optimizer  # noqa: F401
