"""Training on one device — the port of ``ptype_tpu/train``: the
AdamW ``Trainer``, its train and eval steps, and token streams."""

from ptype_tpu_torch.train.data import (TokenFileDataset, synthetic_batches,
                                        write_token_file)
from ptype_tpu_torch.train.trainer import (AdamW, OptHParams, Trainer,
                                           TrainState, default_optimizer,
                                           default_optimizer_hparams,
                                           evaluate, make_eval_step,
                                           make_train_step)

__all__ = [
    "AdamW", "OptHParams", "TokenFileDataset", "TrainState", "Trainer",
    "default_optimizer", "default_optimizer_hparams", "evaluate",
    "make_eval_step", "make_train_step", "synthetic_batches",
    "write_token_file",
]
