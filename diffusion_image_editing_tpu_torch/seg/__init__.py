"""The BiSeNet segmentation trainer: losses, optimizer, data pipeline, loop."""

from .data import (  # noqa: F401
    FaceMaskDataset,
    PrefetchIterator,
    SyntheticFaceMask,
    batch_iterator,
    merge_part_masks,
    multi_scale,
    preprocess_celebamask,
    train_transform,
)
from .losses import cross_entropy_loss, ohem_ce_loss, softmax_focal_loss  # noqa: F401
from .optim import make_optimizer, param_groups, warmup_poly_schedule  # noqa: F401
from .train import (  # noqa: F401
    TrainConfig,
    TrainState,
    create_model,
    create_train_state,
    make_sharded_train_step,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
    shard_batch,
    train_loop,
)
