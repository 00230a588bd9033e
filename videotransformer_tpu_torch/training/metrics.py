"""Top-k accuracy counts and their epoch accumulator.

Port of ``videotransformer_tpu/training/metrics.py``: counts are computed on
the device per step, the host accumulates (correct, total) and computes
epoch means (model_trainer.py:84-105: epoch-end compute + reset).
"""

import torch


def topk_correct(logits, labels, ks=(1, 5)):
    """logits (B, C), labels (B,) int -> {k: correct count (0-d tensor)}.
    A label of -1 (eval padding) matches no index."""
    top = torch.argsort(-logits.float(), dim=-1, stable=True)
    return {k: (top[:, :k] == labels[:, None]).any(dim=-1).sum() for k in ks}


class AccuracyMeter:
    """Host-side accumulator with torchmetrics-like compute/reset."""

    def __init__(self, ks=(1, 5)):
        self.ks = ks
        self.reset()

    def update(self, correct_counts, batch_size):
        for k in self.ks:
            self.correct[k] += int(correct_counts[k])
        self.total += int(batch_size)

    def compute(self, k=1):
        return self.correct[k] / max(1, self.total)

    def reset(self):
        self.correct = {k: 0 for k in self.ks}
        self.total = 0
