"""LR / weight-decay schedules of the trainer.

Port of ``videotransformer_tpu/training/schedules.py`` (plain Python, which
the port cannot import: the JAX package's ``__init__`` imports jax).

- ``cosine_with_warmup_epoch``: the reference's PER-EPOCH cosine lambda with
  linear warmup (model_trainer.py:20-37). ``objective='mim'`` decays to zero;
  supervised keeps a ``min_lr`` floor via factor*(1-min_lr/base)+min_lr/base.
- ``multistep_epoch``: MultiStepLR(milestones=[5, 11], gamma=0.1)
  (model_trainer.py:123-126).
- ``cosine_weight_decay``: the cosine WD ramp applied to the decay param group
  each step, keyed on the current epoch (model_trainer.py:147-153).
"""

import math


def cosine_with_warmup_epoch(epoch, base_lr, warmup_epochs, max_epochs,
                             objective="supervised", min_lr=5e-5):
    """Returns the lr for the given (0-based) epoch."""
    current_step = epoch + 1
    if current_step <= warmup_epochs:
        return base_lr * float(current_step) / float(max(1, warmup_epochs))
    progress = min(
        float(current_step - warmup_epochs)
        / float(max(1, max_epochs - warmup_epochs)), 1.0)
    factor = 0.5 * (1.0 + math.cos(math.pi * progress))
    if objective == "mim":
        return base_lr * factor
    return base_lr * (factor * (1 - min_lr / base_lr) + min_lr / base_lr)


def multistep_epoch(epoch, base_lr, milestones=(5, 11), gamma=0.1):
    factor = 1.0
    for m in milestones:
        if epoch >= m:
            factor *= gamma
    return base_lr * factor


def cosine_weight_decay(epoch, max_epochs, base_value, final_value):
    """model_trainer.py:147-148 ``_get_momentum``."""
    return final_value - (final_value - base_value) * (
        math.cos(math.pi * epoch / max_epochs) + 1) / 2
