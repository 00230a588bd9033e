"""Megatron tensor parallelism over the mesh's model group.

Port of ``videotransformer_tpu/parallel/tp.py`` and of the tensor-parallel
half of ``parallel/sp.py::fused_sharded_call`` (sp.py:131-236). The JAX
package annotates parameter shardings and lets ``shard_map`` hand each
model shard its block; here each rank holds only its shard, in an
``nn.Linear`` of the shard's size, under the full model's names:

- column rules, ``attn.qkv`` and the FFN's ``layers.0.0``: weight rows (the
  output features) and bias split over the model ranks; qkv's rows are
  first permuted into per-head-group ``[q|k|v]`` blocks
  (``qkv_head_block_perm``), so a rank's contiguous block is a valid qkv of
  its ``heads / tp`` heads;
- row rules, ``attn.proj`` and ``layers.1``: weight columns (the input
  features) split; the bias is replicated and added once, after the
  all-reduce;
- everything else (norms, embeddings, ``temporal_fc``, the head) is
  replicated.

``shard_state_dict`` and ``gather_state_dict`` move between the full
canonical state (a checkpoint's, the converter's) and a rank's shard.

``sharded_call`` runs one fused LN -> column product -> ... -> row product
kernel (B1 or B2, forward and backward) on the rank's shard, between the
two Megatron autograd Functions:

- at the block input, identity forward and all-reduce backward (x and the
  LayerNorm weight and bias, which each rank's partial backward reaches);
- after the row product, all-reduce forward and identity backward, in the
  kernel's output dtype, as the JAX package's ``psum`` (sp.py:207-210).

The kernel's row bias is zero; the bias is added once outside
(sp.py:236), so its gradient is not counted tp times. ``validate`` refuses
what the JAX CLI refuses (model_pretrain.py:170-195): a tp that does not
divide the heads, and MViT. Nothing falls back to replication.
"""

import numpy as np
import torch
import torch.distributed as dist

from videotransformer_tpu_torch.parallel import mesh as _mesh

# (the blocks' module lists, column module, row module) of the rules
RULES = ((".attentions.", "attn.qkv", "attn.proj"),
         (".ffns.", "layers.0.0", "layers.1"))
# the head counts of the B/16 builders the CLI validates
# (models/timesformer.py, vivit.py)
B16_HEADS = 12


def qkv_head_block_perm(embed_dims, num_heads, tp):
    """Column permutation turning the fused-QKV kernel's ``[q|k|v]`` layout
    into ``[q_g0|k_g0|v_g0 | q_g1|k_g1|v_g1 | ...]`` over ``tp`` head groups,
    so a contiguous model shard is itself a valid [q|k|v] block for its
    local heads (what the per-shard fused MHSA kernel consumes)."""
    d = embed_dims
    ghd = (num_heads // tp) * (d // num_heads)  # columns per head group
    blocks = []
    for g in range(tp):
        for part in range(3):  # q, k, v
            base = part * d + g * ghd
            blocks.append(np.arange(base, base + ghd))
    return np.concatenate(blocks)


def shard_dim(name):
    """The dim of the tensor ``name`` (a torch name, any prefix) split over
    the model ranks: 0 for a column rule's weight and bias, 1 for a row
    rule's weight; None where it is replicated."""
    parts = name.split(".")
    module, leaf = ".".join(parts[:-1]), parts[-1]
    for group, column, row in RULES:
        if group not in f".{module}.":
            continue
        if module.endswith(column):
            return 0
        if module.endswith(row) and leaf == "weight":
            return 1
    return None


def _is_qkv(name):
    return name.rsplit(".", 1)[0].endswith("attn.qkv")


def validate(arch, tp, num_heads=B16_HEADS):
    """Raise ValueError where the JAX CLI refuses ``-tp`` (model_pretrain.py:
    170-195): MViT, and a tp that does not divide the heads."""
    if tp <= 1:
        return
    if arch == "mvit":
        raise ValueError(
            "-tp > 1 is not supported for -arch mvit: MViT's per-block "
            "head counts start at 1 (stage 0), which no model-axis size "
            "can split. Use -sp/-pp or data parallelism.")
    if num_heads % tp:
        raise ValueError(
            f"-tp {tp} does not divide the attention head count "
            f"({num_heads} for {arch}-B/16); pick tp in "
            f"{[d for d in range(1, num_heads + 1) if num_heads % d == 0]}. "
            "Non-divisible tp would silently replicate the qkv/ffn "
            "params and run without tensor parallelism.")


def shard_state_dict(state, tp, rank, num_heads):
    """Model rank ``rank``'s shard of the full state ``state`` ({name:
    tensor}; names with any prefix, e.g. the optimizer's "model." ones):
    qkv permuted into head-group blocks, then each split tensor's
    ``rank``-th slice. Raises on a tensor that does not split."""
    if tp == 1:
        return dict(state)
    out = {}
    for name, t in state.items():
        dim = shard_dim(name)
        if dim is None:
            out[name] = t
            continue
        if _is_qkv(name):
            t = t[torch.from_numpy(qkv_head_block_perm(
                t.shape[0] // 3, num_heads, tp)).to(t.device)]
        n = t.shape[dim]
        if n % tp:
            raise ValueError(f"{name} {tuple(t.shape)}: dim {dim} does not "
                             f"split over tp={tp}")
        out[name] = t.narrow(dim, rank * (n // tp), n // tp).clone(
            memory_format=torch.contiguous_format)
    return out


def gather_state_dict(shards, num_heads):
    """The full state from the ``tp`` ranks' shards (in model-rank order):
    the inverse of ``shard_state_dict``, bit for bit."""
    tp = len(shards)
    if tp == 1:
        return dict(shards[0])
    out = {}
    for name, t in shards[0].items():
        dim = shard_dim(name)
        if dim is None:
            out[name] = t
            continue
        full = torch.cat([s[name] for s in shards], dim)
        if _is_qkv(name):
            perm = torch.from_numpy(qkv_head_block_perm(
                full.shape[0] // 3, num_heads, tp)).to(full.device)
            unperm = torch.empty_like(full)
            unperm[perm] = full
            full = unperm
        out[name] = full
    return out


def gather_over_model(state, mesh, num_heads):
    """The full state from this rank's shard ``state``, over the mesh's
    model group (every model rank calls it; each receives the whole)."""
    if mesh is None or mesh.model == 1:
        return dict(state)
    shards = [{} for _ in range(mesh.model)]
    for name, t in state.items():
        if shard_dim(name) is None:
            for s in shards:
                s[name] = t
            continue
        parts = _mesh.all_gather(t[None], mesh.model_ranks, mesh.model_group)
        for s, part in zip(shards, parts):
            s[name] = part
    return gather_state_dict(shards, num_heads)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradients summed over the model group backward
    (one coalesced all-reduce). Megatron's f, at a block's input."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        grads = [None if g is None else g.contiguous().clone()
                 for g in grads]
        _mesh.all_reduce_coalesced([g for g in grads if g is not None],
                                   ctx.group)
        return (None, *grads)


class _ReduceFromModel(torch.autograd.Function):
    """The partial outputs summed over the model group forward; identity
    backward. Megatron's g, after the row product."""

    @staticmethod
    def forward(ctx, group, x):
        x = x.clone()  # the kernel's output may be a view of its own
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return None, g


def sharded_call(fn, mesh, x, ln_w, ln_b, w_col, b_col, w_row, b_row):
    """``fn(x, ln_w, ln_b, w_col, b_col, w_row, b_row)`` (a fused LN ->
    column product -> ... -> row product call) on this rank's shard under
    the tensor parallelism of ``mesh``: the row bias zero inside ``fn``,
    the partial outputs summed over the model group, the bias added once.
    ``fn`` must take its head count from ``w_col``'s width. The plain call
    without a model group."""
    if _mesh.model_ranks(mesh) == 1:
        return fn(x, ln_w, ln_b, w_col, b_col, w_row, b_row)
    group = mesh.model_group
    x, ln_w, ln_b = _CopyToModel.apply(group, x, ln_w, ln_b)
    out = fn(x, ln_w, ln_b, w_col, b_col, w_row, torch.zeros_like(b_row))
    return _ReduceFromModel.apply(group, out) + b_row
