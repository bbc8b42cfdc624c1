"""Training layer of the port.

Counterpart of ``vltk_tpu/train/``: ``optim.py`` (AdamW, linear warmup and
decay, clipping), ``steps.py`` (train and eval steps, gradient
accumulation), ``checkpoint.py`` (``torch.save`` checkpoints with the same
layout and resume rules), ``experiment.py`` (``SimpleExperiment``) and
``metrics.py`` (``accuracy``, ``vqa_score``). ``ComplexExperiment`` and the
detection metrics wait for their slices (ROADMAP A.13).
"""

from vltk_tpu_torch.train.checkpoint import latest_epoch, load_checkpoint, save_checkpoint
from vltk_tpu_torch.train.experiment import SimpleExperiment
from vltk_tpu_torch.train.metrics import accuracy, vqa_score
from vltk_tpu_torch.train.optim import linear_warmup_linear_decay, make_optimizer
from vltk_tpu_torch.train.steps import make_eval_step, make_train_step

__all__ = [
    "SimpleExperiment",
    "accuracy",
    "latest_epoch",
    "linear_warmup_linear_decay",
    "load_checkpoint",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "save_checkpoint",
    "vqa_score",
]
