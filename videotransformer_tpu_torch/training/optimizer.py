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
- MViT's layer-wise LR decay (optimizer.py:53-75, 414-416): each parameter's
  lr (and so its decoupled decay) is scaled by
  ``layer_decay ** (17 - mvit_layer_id(name))``; the trainer passes these
  scales for a supervised ``arch='mvit'`` run with ``layer_decay != 1``.

Under data and tensor parallelism (a ``mesh``, ``parallel/mesh.py``):

- ``reduce_gradients`` sums every gradient over the data group in one
  coalesced all-reduce, in the parameters' order (so a step repeats to the
  bit); the trainer makes each rank's loss its share of the global one;
- a parameter split over the model ranks (``sharded``) is clipped by the
  norm of the whole tensor, its shards' squared norms summed over the
  model group (the per-shard norm would clip it wrongly), and the logged
  total norm counts every element once.

``lr`` and ``wd`` arrive per step from the epoch schedules. State is plain
tensors keyed by parameter name (``state_dict``/``load_state_dict`` for
checkpoints). The clip and the AdamW update run as ``torch._foreach_*``
multi-tensor operations: the same per-tensor arithmetic (up to the order of
a multiply-add), in a handful of launches for all ~200 tensors instead of
about ten per tensor.
"""

import torch
import torch.distributed as dist

from videotransformer_tpu_torch.parallel.mesh import all_reduce_coalesced

SKIP_KEYWORDS = ("pos_embed", "cls_token", "mask_token")


def no_decay(name, param, skip_keywords=SKIP_KEYWORDS):
    """True where weight decay must NOT apply (optimizer.py:52-53)."""
    return (param.dim() == 1 or name.endswith("bias")
            or any(k in name for k in skip_keywords))


def mvit_layer_id(name, num_layers=18):
    """optimizer.py:53-66 on the trainer's torch names ("model.mvit.blocks.3.
    ..."): the mask token, patch embed and positional encoding are layer 0,
    block i is layer i + 1, the rest (final norm, head) num_layers - 1."""
    p = name.replace("model.", "").replace("mvit.", "")
    if p.startswith(("mask_token", "patch_embed", "cls_positional_encoding")):
        return 0
    if p.startswith("blocks."):
        return int(p.split(".")[1]) + 1
    return num_layers - 1


def layer_scales(names, layer_decay, num_layers=18):
    """{name: layer_decay ** (num_layers - 1 - layer id)} (optimizer.py:69-75)."""
    return {n: layer_decay ** (num_layers - 1 - mvit_layer_id(n, num_layers))
            for n in names}


class RefOptimizer:
    """step(lr, wd) -> total grad norm, over ``named_params`` (name, param)
    whose ``.grad`` the backward filled; ``lr_scales`` ({name: scale}, or
    None for 1 everywhere) scales each parameter's lr. ``mesh`` and
    ``sharded`` (the names split over its model ranks): see the module
    doc."""

    def __init__(self, named_params, optim_type="adamw", betas=(0.9, 0.999),
                 eps=1e-8, momentum=0.9, nesterov=True, clip_grad=0.0,
                 lr_scales=None, mesh=None, sharded=()):
        self.params = dict(named_params)
        self.mesh = mesh
        self.sharded = None
        if mesh is not None and mesh.model > 1:
            self.sharded = torch.tensor([n in set(sharded)
                                         for n in self.params],
                                        device=mesh.device)
        self.lr_scales = {n: float((lr_scales or {}).get(n, 1.0))
                          for n in self.params}
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

    def reduce_gradients(self, extra=()):
        """Sum every gradient (zero where the loss did not reach a
        parameter) and the tensors ``extra`` over the mesh's data group, in
        place, in one all-reduce per dtype."""
        for p in self.params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        all_reduce_coalesced([p.grad for p in self.params.values()]
                             + list(extra), self.mesh.data_group)

    def _clipped_grads(self, names):
        """Per-parameter clip (each gradient scaled by min(1, clip / (its
        norm + 1e-6))); returns (grads in ``names`` order, total norm). A
        parameter the loss did not reach (MViT's mask token in a supervised
        run) has a zero gradient, as jax.grad gives it."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in (self.params[n] for n in names)]
        norms = torch.stack(torch._foreach_norm(grads))
        if self.sharded is not None:  # the whole tensor's norm
            part = torch.where(self.sharded, norms * norms, 0.0)
            dist.all_reduce(part, group=self.mesh.model_group)
            norms = torch.where(self.sharded, part.sqrt(), norms)
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
            decay = [n for n in names if not self.no_decay[n]]
            if decay:
                torch._foreach_mul_(
                    [self.params[n] for n in decay],
                    [1 - lr * self.lr_scales[n] * wd for n in decay])
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            update = torch._foreach_div(mu, bc1)
            torch._foreach_div_(update, denom)
            torch._foreach_mul_(update, [-lr * self.lr_scales[n] for n in names])
            torch._foreach_add_(params, update)
        else:
            for n, p, g, buf in zip(names, params, grads, mu):
                d = g + (0.0 if self.no_decay[n] else wd) * p
                buf.mul_(self.momentum).add_(d)
                d = d + self.momentum * buf if self.nesterov else buf
                p.sub_(lr * self.lr_scales[n] * d)
        return total

    def state_dict(self):
        return {"step": self.step_count, "mu": dict(self.mu),
                "nu": dict(self.nu)}

    def load_state_dict(self, state):
        self.step_count = int(state["step"])
        for n in self.params:
            self.mu[n].copy_(state["mu"][n])
            self.nu[n].copy_(state["nu"][n])
