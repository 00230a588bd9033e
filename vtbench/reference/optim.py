"""AdamW as the configurations state it, plain.

torch's AdamW semantics (Loshchilov and Hutter, arXiv:1711.05101) with the
groups of the original repo's optimizer, as ``training/optimizer.py`` of
the port states them: no weight decay for 1-D parameters, biases and the
names holding pos_embed, cls_token or mask_token; decoupled decay
``p *= 1 - lr·wd`` on the rest; bias-corrected moments; no clipping at
``clip_grad`` 0."""

import torch

SKIP = ("pos_embed", "cls_token", "mask_token")


def no_decay(name, shape):
    return len(shape) == 1 or name.endswith("bias") or \
        any(k in name for k in SKIP)


class AdamW:
    def __init__(self, params, betas=(0.9, 0.999), eps=1e-8):
        self.params = params  # {name: fp32 tensor}, updated in place
        self.b1, self.b2 = betas
        self.eps = eps
        self.t = 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, grads, lr, wd):
        self.t += 1
        bc1 = 1 - self.b1 ** self.t
        bc2 = 1 - self.b2 ** self.t
        for n, p in self.params.items():
            g = grads[n]
            m, v = self.m[n], self.v[n]
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            if not no_decay(n, p.shape):
                p.mul_(1 - lr * wd)
            p.sub_(lr * (m / bc1) / ((v / bc2).sqrt() + self.eps))
