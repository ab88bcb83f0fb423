"""Training — the port of ``ptype_tpu/train``: the AdamW ``Trainer`` on
one device or a mesh, its train and eval steps, token streams, and the
optimizers the eager trainers step with (``Adam``, ``SGD``,
``make_apply_fn``). The async param server and the actor-per-layer
pipeline are ``train/param_server.py`` and ``train/actor_pipeline.py``."""

from ptype_tpu_torch.train.data import (TokenFileDataset, local_row_range,
                                        synthetic_batches, write_token_file)
from ptype_tpu_torch.train.trainer import (SGD, Adam, AdamW, OptHParams,
                                           Trainer, TrainState,
                                           default_optimizer,
                                           default_optimizer_hparams,
                                           evaluate, make_apply_fn,
                                           make_eval_step, make_train_step)

__all__ = [
    "Adam", "AdamW", "OptHParams", "SGD", "TokenFileDataset", "TrainState", "Trainer",
    "default_optimizer", "default_optimizer_hparams", "evaluate",
    "local_row_range", "make_apply_fn", "make_eval_step", "make_train_step",
    "synthetic_batches", "write_token_file",
]
