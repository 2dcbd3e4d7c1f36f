from vitvs_tpu_torch.train.finetune import (
    TrainState,
    geometric_correspondences,
    info_nce_loss,
    make_pair_batch,
    make_train_step,
    train_descriptor_model,
)

__all__ = [
    "TrainState",
    "geometric_correspondences",
    "info_nce_loss",
    "make_pair_batch",
    "make_train_step",
    "train_descriptor_model",
]
