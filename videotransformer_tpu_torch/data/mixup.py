"""Mixup / CutMix on a batch of clips.

Port of ``videotransformer_tpu/data/mixup.py`` (timm-derived, batch mode):
one draw per batch of (apply?, cutmix?, lam_mixup ~ Beta(0.8, 0.8),
lam_cutmix ~ Beta(1, 1), box centre); pairing by ``flip(0)``; the cut box
applies to every frame; the cutmix lambda is always corrected by the box's
actual area (the JAX Mixup's ``correct_lam=True``, the only setting its
trainer uses); soft targets are one-hot with label smoothing 0.1, mixed by
lam.

The draws come from a ``torch.Generator`` (``sample_draws``) and are plain
Python numbers, so a caller can also hand them in (``apply``): jax.random
and torch never give the same numbers, and the tests feed both packages the
same draws. The arithmetic on the draws is done in float32, as the JAX
package does it.

Under data parallelism a rank holds rows of the global batch, and the
flipped batch's rows at its positions are those of another rank, flipped:
``partner`` hands them in (the trainer exchanges them).
"""

import numpy as np
import torch

f32 = np.float32


def mixup_target(target, num_classes, lam=1.0, smoothing=0.0,
                 partner=None):
    """(B,) labels -> (B, num_classes) fp32 soft targets mixed with the
    flipped batch's (``partner``'s flipped, where given)."""
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    smooth = lambda t: torch.nn.functional.one_hot(
        t.long(), num_classes).float() * (on - off) + off
    y1 = smooth(target)
    y2 = (y1 if partner is None else smooth(partner)).flip(0)
    return y1 * float(lam) + y2 * float(f32(1.0) - f32(lam))


def _beta(generator, a, b, device):
    """One Beta(a, b) draw by Jöhnk's method (exact for any a, b > 0), from
    uniforms of ``generator``."""
    while True:
        u, v = torch.rand(2, generator=generator, dtype=torch.float64,
                          device=device).tolist()
        x, y = u ** (1.0 / a), v ** (1.0 / b)
        if 0.0 < x + y <= 1.0:
            return x / (x + y)


class Mixup:
    """Batch-mode Mixup/CutMix: ``mixup(x, target, generator)`` -> (mixed
    x, soft targets)."""

    def __init__(self, mixup_alpha=0.8, cutmix_alpha=1.0, prob=1.0,
                 switch_prob=0.5, label_smoothing=0.1, num_classes=1000):
        self.mixup_alpha = mixup_alpha
        self.cutmix_alpha = cutmix_alpha
        self.mix_prob = prob
        self.switch_prob = switch_prob
        self.label_smoothing = label_smoothing
        self.num_classes = num_classes

    def sample_draws(self, generator, h, w, device):
        """The random numbers of one batch (mixup.py:68-74, 41-43)."""
        u = torch.rand(2, generator=generator, dtype=torch.float32,
                       device=device).tolist()
        cy, cx = (int(torch.randint(0, n, (1,), generator=generator,
                                    device=device)) for n in (h, w))
        return {"do_mix": u[0] < self.mix_prob,
                "use_cutmix": u[1] < self.switch_prob,
                "lam_mixup": _beta(generator, self.mixup_alpha,
                                   self.mixup_alpha, device),
                "lam_cutmix": _beta(generator, self.cutmix_alpha,
                                    self.cutmix_alpha, device),
                "cy": cy, "cx": cx}

    def __call__(self, x, target, generator, partner=None):
        h, w = x.shape[-2], x.shape[-1]
        return self.apply(x, target,
                          self.sample_draws(generator, h, w, x.device),
                          partner)

    def apply(self, x, target, draws, partner=None):
        """x (B, T, C, H, W) float, target (B,) int, with the given draws
        (mixup.py:76-96); each row mixed with the flipped batch's, or with
        ``partner``'s (x, target) flipped."""
        h, w = x.shape[-2], x.shape[-1]
        do_mix, use_cutmix = draws["do_mix"], draws["use_cutmix"]
        lam_m = f32(draws["lam_mixup"]) if do_mix else f32(1.0)
        x_p, target_p = (x, None) if partner is None else partner
        x_flip = x_p.flip(0)
        if use_cutmix and do_mix:
            ratio = np.sqrt(f32(1.0) - f32(draws["lam_cutmix"]))
            cut_h, cut_w = int(f32(h) * ratio), int(f32(w) * ratio)
            cy, cx = draws["cy"], draws["cx"]
            yl, yh = np.clip([cy - cut_h // 2, cy + cut_h // 2], 0, h)
            xl, xh = np.clip([cx - cut_w // 2, cx + cut_w // 2], 0, w)
            x_out = x.clone()
            x_out[..., yl:yh, xl:xh] = x_flip[..., yl:yh, xl:xh]
            # lambda corrected by the box's clipped area (correct_lam)
            lam = f32(1.0) - f32((yh - yl) * (xh - xl)) / f32(h * w)
        else:
            x_out = x * float(lam_m) + x_flip * float(f32(1.0) - lam_m)
            lam = (f32(1.0) if use_cutmix else lam_m)
        y = mixup_target(target, self.num_classes, lam, self.label_smoothing,
                         target_p)
        return x_out, y
