"""The trainer's optimizer: AdamW / SGD-nesterov with the reference's groups.

Port of ``videotransformer_tpu/training/optimizer.py::RefOptimizer`` in its
per-tensor form (optimizer.py:350-400):

- no-decay group: 1-D parameters, ``bias`` parameters, and the skip keywords
  pos_embed / cls_token / mask_token (optimizer.py:39-50); ``time_embed``
  is 3-D and not a keyword, so it is decayed. On torch names
  (``norm.weight``, ``qkv.bias``) this gives the groups the JAX rule gives
  on the flax paths (``norm/scale``, ``qkv/bias``).
- per-parameter gradient clipping, each gradient clipped to ``clip_grad`` by
  its own L2 norm, and the logged total norm is the norm of the per-param
  norms (optimizer.py:252-274). It is not global-norm clipping.
- AdamW with torch semantics: p *= 1 - lr·wd (decay group only); p -=
  lr · m̂ / (sqrt(v̂) + eps); SGD with nesterov momentum as torch's.

``lr`` and ``wd`` arrive per step from the epoch schedules. State is plain
tensors keyed by parameter name (``state_dict``/``load_state_dict`` for
checkpoints). The clip and the AdamW update run as ``torch._foreach_*``
multi-tensor operations: the same per-tensor arithmetic (up to the order of
a multiply-add), in a handful of launches for all ~200 tensors instead of
about ten per tensor. MViT's layer-wise LR decay waits for the MViT port.
"""

import torch

SKIP_KEYWORDS = ("pos_embed", "cls_token", "mask_token")


def no_decay(name, param, skip_keywords=SKIP_KEYWORDS):
    """True where weight decay must NOT apply (optimizer.py:52-53)."""
    return (param.dim() == 1 or name.endswith("bias")
            or any(k in name for k in skip_keywords))


class RefOptimizer:
    """step(lr, wd) -> total grad norm, over ``named_params`` (name, param)
    whose ``.grad`` the backward filled."""

    def __init__(self, named_params, optim_type="adamw", betas=(0.9, 0.999),
                 eps=1e-8, momentum=0.9, nesterov=True, clip_grad=0.0):
        self.params = dict(named_params)
        self.optim_type = optim_type.lower()
        if self.optim_type not in ("adamw", "sgd"):
            raise ValueError(self.optim_type)
        self.betas = betas
        self.eps = eps
        self.momentum = momentum
        self.nesterov = nesterov
        self.clip_grad = clip_grad
        self.no_decay = {n: no_decay(n, p) for n, p in self.params.items()}
        self.step_count = 0
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}

    def zero_grad(self):
        for p in self.params.values():
            p.grad = None

    def _clipped_grads(self, names):
        """Per-parameter clip (each gradient scaled by min(1, clip / (its
        norm + 1e-6))); returns (grads in ``names`` order, total norm)."""
        grads = [self.params[n].grad for n in names]
        norms = torch.stack(torch._foreach_norm(grads))
        total = torch.sqrt((norms * norms).sum())
        if self.clip_grad and self.clip_grad > 0:
            coef = (self.clip_grad / (norms + 1e-6)).clamp(max=1.0)
            grads = torch._foreach_mul(grads, list(coef.unbind()))
        return grads, total

    @torch.no_grad()
    def step(self, lr, wd):
        names = list(self.params)
        grads, total = self._clipped_grads(names)
        self.step_count += 1
        params = [self.params[n] for n in names]
        mu = [self.mu[n] for n in names]
        if self.optim_type == "adamw":
            b1, b2 = self.betas
            # bias corrections in fp32, as the JAX update computes them
            t = torch.tensor(float(self.step_count))
            bc1 = float(1 - torch.tensor(b1) ** t)
            bc2 = float(1 - torch.tensor(b2) ** t)
            nu = [self.nu[n] for n in names]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
            decay = [p for n, p in zip(names, params) if not self.no_decay[n]]
            if decay:
                torch._foreach_mul_(decay, 1 - lr * wd)
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            update = torch._foreach_div(mu, bc1)
            torch._foreach_div_(update, denom)
            torch._foreach_add_(params, update, alpha=-lr)
        else:
            for n, p, g, buf in zip(names, params, grads, mu):
                d = g + (0.0 if self.no_decay[n] else wd) * p
                buf.mul_(self.momentum).add_(d)
                d = d + self.momentum * buf if self.nesterov else buf
                p.sub_(lr * d)
        return total

    def state_dict(self):
        return {"step": self.step_count, "mu": dict(self.mu),
                "nu": dict(self.nu)}

    def load_state_dict(self, state):
        self.step_count = int(state["step"])
        for n in self.params:
            self.mu[n].copy_(state["mu"][n])
            self.nu[n].copy_(state["nu"][n])
