"""Training: the port of ``consistent_depth_tpu/training``. The engine's
passes (train step and epoch, the paired and deduplicated eval passes,
eval-mode inference), the optimizers, the fine-tune driver with its
``.pth`` and full-state checkpoints and TensorBoard events, and the host
helpers they draw on: the dataset loaders and pair-batch iterator, the
frame range and pair sampling (the port's own copies, ``data.video_dataset``
and ``utils``).
"""

from ..data.video_dataset import (  # noqa: F401
    PairBatchIterator, PairData, VideoFrameDataset, VideoPairDataset)
from ..utils import frame_range, frame_sampling  # noqa: F401
from .engine import TrainingEngine, gather_batch  # noqa: F401
from .fine_tuning import (  # noqa: F401
    DepthFineTuner, DepthFineTuningParams, LossParams, capture_slots,
    eval_batches, make_tag)
from .optimizer import create as create_optimizer  # noqa: F401
