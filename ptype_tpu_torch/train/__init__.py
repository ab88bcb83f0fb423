"""Training — the port of ``ptype_tpu/train``: the AdamW ``Trainer`` on
one device or a mesh, its train and eval steps, and token streams."""

from ptype_tpu_torch.train.data import (TokenFileDataset, local_row_range,
                                        synthetic_batches, write_token_file)
from ptype_tpu_torch.train.trainer import (AdamW, OptHParams, Trainer,
                                           TrainState, default_optimizer,
                                           default_optimizer_hparams,
                                           evaluate, make_eval_step,
                                           make_train_step)

__all__ = [
    "AdamW", "OptHParams", "TokenFileDataset", "TrainState", "Trainer",
    "default_optimizer", "default_optimizer_hparams", "evaluate",
    "local_row_range", "make_eval_step", "make_train_step",
    "synthetic_batches", "write_token_file",
]
