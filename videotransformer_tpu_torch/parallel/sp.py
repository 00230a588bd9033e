"""Sequence parallelism: a clip's tokens split over the mesh's seq ranks.

Port of ``videotransformer_tpu/parallel/sp.py``. The JAX package sets
shardings (``constrain_rows``, ``constrain_tokens``) and lets XLA move the
data; here each rank holds its part of the activations and the blocks move
them explicitly (``ops/blocks.py``), over the seq group of
``parallel/mesh.py``. A step over a (data, seq, model) mesh computes what
one process computes on the global batch.

The layout between blocks (divided and joint attention, TimeSformer and
ViViT): seq rank s holds ``(b, 1 + (p / sp) · t, d)``, the cls row and the
tokens of its p / sp patches, which in the patch-major order ``b (p t) d``
are contiguous (``shard``). So:

- temporal attention runs on the rank's ``(b · p / sp, t, d)`` rows as one
  process runs them, and the FFN on the rank's tokens, cls row included
  (no peel: JAX's ``token_sharded_call`` sends the cls row through the jnp
  twin because n = 1 + p·t does not divide by sp);
- spatial attention needs frames over seq, ``(b · t / sp, 1 + p, d)``:
  one all-to-all in (``to_frames``) and one out (``to_patches``), JAX's
  ``constrain_rows`` transitions. The cls row's mean over frames sums the
  ranks' frames over the seq group (``mesh.sum_over_seq``);
- joint attention runs ``ring_prenorm_mhsa`` on the rank's tokens, the
  cls row's key and value entering the softmax once.

The cls row is replicated: every seq rank computes it, and from it the
logits and the loss. Each rank back-propagates loss / sp, and the cls
mean's all-reduce sums its gradient over the ranks in the backward, so the
parameter gradients summed over (data × seq) (``Mesh.replica_group``) are
one process's, the replicated path counted once.

Rows that a DropPath draws over (temporal ``b · p``, spatial ``b · t``) are
cut from the global draw as (clip, patch) and (clip, frame) pairs
(``mesh.rand_rows(..., clips=b)``); the FFN's per-clip draw is the same on
every seq rank.

ViViT's ``fact_encoder`` and TimeSformer's ``space_only`` shard their
per-frame rows over frames instead (``frames`` layout): every row stays
whole on one rank, and the frames are gathered (``mesh.gather_seq``) where
the model needs them all. The fact_encoder temporal stack (``1 + T'``
tokens) runs replicated under the same loss / sp rule.

``ring_prenorm_mhsa`` is JAX's ring (sp.py:248-337) in torch ops, as JAX
writes it in jnp: LayerNorm with flax's fast variance, the qkv product,
then an online softmax over K/V blocks that go round the seq ranks
(``mesh.ring_shift``; the backward is autograd through the reverse ring),
scores in fp32 and p cast to the working type for the PV product. It
computes in fp32 and rounds to the working type where JAX's does, with
the gradient passed through those roundings in fp32 (``_rounded``), so
its backward keeps fp32 where B3's does (a bf16 backward through autograd
rounds every intermediate gradient). It takes JAX's layout
(``token_chunk``: contiguous chunks of ceil(n / sp) tokens, the tail
padded and masked by the origin of each block) or the model's (the first
``shared`` tokens, the cls row, the same on every rank). Under tensor
parallelism it runs inside ``tp.sharded_call`` over the rank's heads.

``validate`` refuses what the JAX CLI refuses (model_pretrain.py:193-205).
"""

import math

import torch
import torch.nn.functional as F

from videotransformer_tpu_torch.parallel import mesh as _mesh

# JAX's mask value for the padded key columns (sp.py:313)
MASKED = -1e30


def validate(arch, attention_type, num_frames, img_size, sp,
             patch_size=16):
    """Raise ValueError where the JAX CLI refuses ``-sp`` (model_pretrain.
    py:193-205, its messages): an attention type without divided rows, and
    an sp that does not divide both the (effective) frame count and the
    patch count."""
    if sp <= 1:
        return
    if attention_type not in ("divided_space_time", "fact_encoder"):
        raise ValueError(
            f"-sp > 1 requires divided attention rows "
            f"(attention_type divided_space_time/fact_encoder), got "
            f"{attention_type}")
    frames = num_frames // 2 if arch == "vivit" else num_frames
    patches = (img_size // patch_size) ** 2
    if frames % sp or patches % sp:
        raise ValueError(
            f"-sp {sp} must divide both the (effective) frame count "
            f"({frames}) and the patch count ({patches}); a "
            f"non-divisible sp falls back to unsharded attention rows.")


def check_divides(what, n, mesh):
    """Raise ValueError unless the seq ranks of ``mesh`` split ``n``."""
    sp = _mesh.seq_ranks(mesh)
    if n % sp:
        raise ValueError(f"sp={sp} does not divide the {n} {what}")


def shard(n, mesh):
    """This seq rank's slice of ``n`` items split evenly over the seq
    ranks (all of them without a seq group)."""
    sp = _mesh.seq_ranks(mesh)
    if sp == 1:
        return slice(None)
    check_divides("items", n, mesh)
    k = n // sp
    return slice(mesh.seq_rank * k, (mesh.seq_rank + 1) * k)


def to_frames(x, mesh):
    """``(b, p / sp, t, d)`` (this rank's patches, every frame) ->
    ``(b, p, t / sp, d)`` (every patch, this rank's frames): one
    all-to-all over the seq group."""
    return _mesh.all_to_all(x, mesh, split_dim=2, cat_dim=1)


def to_patches(x, mesh):
    """The inverse of ``to_frames``."""
    return _mesh.all_to_all(x, mesh, split_dim=1, cat_dim=2)


def seq_mean(x, mesh):
    """x (b, k, ...) -> its mean over k, keeping the dim; under sequence
    parallelism the mean over every seq rank's k: this rank's sum summed
    over the seq group (``mesh.sum_over_seq``, whose backward reaches
    every rank's terms)."""
    if _mesh.seq_ranks(mesh) == 1:
        return x.mean(dim=1, keepdim=True)
    k = x.shape[1] * mesh.seq
    return _mesh.sum_over_seq(x.sum(dim=1, keepdim=True), mesh) / k


def token_chunk(x, mesh):
    """JAX's ring layout (sp.py:296-300): this seq rank's contiguous chunk
    of ceil(n / sp) tokens of ``x`` (b, n, d), the tail padded with zeros."""
    sp = _mesh.seq_ranks(mesh)
    n = x.shape[1]
    n_l = -(-n // sp)
    if n_l * sp > n:
        x = F.pad(x, (0, 0, 0, n_l * sp - n))
    r = 0 if sp == 1 else mesh.seq_rank
    return x[:, r * n_l:(r + 1) * n_l]


def _rounded(x, dtype):
    """fp32 ``x`` holding the values of ``x.to(dtype)``, its gradient
    passed through unrounded: a rounding of the working type in the
    forward, none in the backward."""
    if dtype == torch.float32:
        return x
    return x + (x.to(dtype).float() - x).detach()


def _layer_norm_fast(x, w, b, eps):
    """flax's LayerNorm numerics (the fast variance E[x²] - E[x]², fp32
    statistics, the normalised x rounded to the working type, then the
    affine), as JAX's ring computes it (sp.py:287-291); fp32 out."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    xhat = _rounded((xf - mu) * torch.rsqrt(var + eps), x.dtype)
    return _rounded(xhat * w.float() + b.float(), x.dtype)


def _attend(state, q, k, v, scale, dtype, valid=None):
    """One block of the online softmax (sp.py:304-322): fp32 scores, the
    key columns from ``valid`` on masked, p rounded to the working type
    ``dtype`` for the PV product. The running max takes no gradient: the
    output does not depend on it."""
    m, l, acc = state
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if valid is not None and valid < k.shape[2]:
        cols = torch.arange(k.shape[2], device=s.device)
        s = torch.where(cols < valid, s, MASKED)
    m_new = torch.maximum(m, s.amax(-1)).detach()
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * alpha + p.sum(-1)
    acc = acc * alpha[..., None] + torch.matmul(_rounded(p, dtype), v)
    return m_new, l, acc


def ring_prenorm_mhsa(x, ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj,
                      head_dim, scale, eps, mesh, n=None, shared=0):
    """Prenorm MHSA over the tokens of every seq rank, from this rank's
    ``x`` (b, n_l, d) (sp.py:248-337): LayerNorm, qkv for the heads of
    ``w_qkv`` (its rows / (3 · head_dim): a tensor-parallel shard's), an
    online softmax over the K/V blocks of every rank, passed round the
    ring, the projection with its bias. Returns this rank's (b, n_l, d)
    output, before the residual; the weights are torch's (out, in).

    ``n``: JAX's layout (``token_chunk``): the rank of origin o of a block
    holds its first clip(n - o · n_l, 0, n_l) columns as tokens, the rest
    padding, masked. ``shared``: the model's layout: the first ``shared``
    tokens of ``x`` (the cls row) are the same on every seq rank, so their
    keys and values enter once, here, and the ring carries the others."""
    b, n_l, _ = x.shape
    dt = x.dtype
    heads = w_qkv.shape[0] // (3 * head_dim)
    xn = _layer_norm_fast(x, ln_w, ln_b, eps)
    qkv = _rounded(F.linear(xn, w_qkv.float(), b_qkv.float()), dt)
    q, k, v = qkv.reshape(b, n_l, 3, heads, head_dim).permute(
        2, 0, 3, 1, 4).unbind(0)
    state = (torch.full((b, heads, n_l), -math.inf, device=x.device),
             torch.zeros((b, heads, n_l), device=x.device),
             torch.zeros((b, heads, n_l, head_dim), device=x.device))
    if shared:
        state = _attend(state, q, k[:, :, :shared], v[:, :, :shared], scale,
                        dt)
    kv = torch.stack([k[:, :, shared:], v[:, :, shared:]])
    sp = _mesh.seq_ranks(mesh)
    block = kv.shape[3]
    for i in range(sp):
        origin = 0 if sp == 1 else (mesh.seq_rank - i) % sp
        valid = None if n is None else min(max(n - origin * block, 0),
                                           block)
        state = _attend(state, q, kv[0], kv[1], scale, dt, valid)
        if i + 1 < sp:
            kv = _mesh.ring_shift(kv, mesh)
    _, l, acc = state
    out = _rounded(acc / l.clamp_min(1e-30)[..., None], dt)
    out = out.transpose(1, 2).reshape(b, n_l, heads * head_dim)
    return F.linear(out, w_proj.float(), b_proj.float()).to(dt)
