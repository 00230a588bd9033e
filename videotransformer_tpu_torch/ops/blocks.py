"""Transformer building blocks of TimeSformer and ViViT: divided and joint
space-time attention, the FFN, the per-frame and tubelet patch embeddings.

Port of ``videotransformer_tpu/ops/blocks.py``. Module and parameter names
are the original PyTorch repo's, i.e. what
``videotransformer_tpu.models.convert.flax_to_torch_state_dict`` emits, so a
converted state dict loads with ``strict=True``.

The prenorm attentions and the FFN call the two fused kernels
(``kernels.fused_mhsa``, ``kernels.fused_ffn``), forward and backward: on a
CUDA tensor these launch the hand-written kernels, on a CPU tensor they run
the kernels' plain versions. Joint attention at head dim 64 is one fused
call at every length; at other head dims, above 2048 tokens, it takes the
unfused form the JAX package takes there, its core the flash attention
kernel (``kernels.flash_attention``).

The working type is the activations' dtype. Every parameter is cast to it
at its use, as the JAX package casts its fp32 parameters
(blocks.py:318-323): training keeps fp32 parameters and feeds bf16 clips;
serving casts the model to bf16 once, and the casts are then no-ops.

DropPath (stochastic depth) acts in training mode only, with the keep mask
over the leading axis of the tensor it is applied to (blocks.py:61-79): one
draw per ``(b·p)`` temporal row, per ``(b·t)`` spatial row and per sample in
the FFN, placed where the JAX blocks place it (blocks.py:331-334, 433-434,
602). Its uniforms come from the ``generator`` passed down the forward,
drawn for the global batch under data parallelism (``mesh.rand_rows``).

``TransformerContainer(remat=True)`` is the JAX container's ``nn.remat``
per block (blocks.py:698-736): while autograd records, each block runs
under ``torch.utils.checkpoint`` and keeps only its input, and the backward
runs its forward again, kernels included. DropPath's draws in that second
forward come from the generator set back to its state before the block, so
they are the first forward's, and the generator then goes back to where it
was: the steps are those without remat, to the bit.

``return_attention`` (the JAX modules' keyword) returns the softmax
weights of the last block's last attention and runs nothing after it:
the blocks before it run as usual, and that attention takes the JAX
package's plain ``Attention`` with ``need_weights`` (blocks.py:153-183),
which JAX runs on its XLA path and never on a Pallas kernel, so here it is
plain PyTorch on the card too. ``last_selfattention`` is the models'
``get_last_selfattention``.

A block is built with the ``mesh`` of a parallel run (``parallel/mesh.py``;
None for one process), which it keeps. Tensor parallelism (a mesh of
``model`` > 1 ranks, ``parallel/tp.py``): the block holds its shard of qkv
and fc1 (rows) and of proj and fc2 (columns) under the full model's names,
and runs B1 or B2 (B3 or B4 backward) on it inside ``tp.sharded_call``
(JAX blocks.py:302-324,
395-402, 506-513, 585-591): the head count from the shard's width, the
partial outputs summed over the model group, the row bias added once; the
residual stays outside the kernel. Joint attention's unfused branch
(flash attention over the rank's heads) is sharded the same way. A
sharded block is initialised by sharding a full one (``reset_parameters``
refuses).

Sequence parallelism (a mesh of ``seq`` > 1 ranks, ``parallel/sp.py``):
a block holds this rank's part of the activations in its stack's
``seq_layout``. ``tokens`` (divided and joint attention): the cls row and
this rank's patches' tokens; the temporal attention and the FFN run on
them as one process runs them, the spatial attention moves to frames over
seq and back (one all-to-all each way, JAX blocks.py:276, 427) with the
cls row's frame mean summed over the seq group (blocks.py:430-440), and
joint attention runs the ring (blocks.py:475-493). ``frames`` (ViViT's
fact_encoder spatial stack, TimeSformer's space_only): this rank's frames'
rows, each whole. ``replicated`` (the fact_encoder temporal stack): every
seq rank runs the same rows. DropPath cuts this rank's rows from the
global draw in every layout.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from videotransformer_tpu_torch.kernels import (
    flash_attention, fused_ffn, fused_mhsa)
from videotransformer_tpu_torch.kernels._plain import layer_norm
from videotransformer_tpu_torch.ops import initializers as init
from videotransformer_tpu_torch.parallel import mesh as _mesh
from videotransformer_tpu_torch.parallel import sp as _sp
from videotransformer_tpu_torch.parallel import tp as _tp
from videotransformer_tpu_torch.utils import profiling

LN_EPS = 1e-5  # LayerNorm eps inside the blocks (torch's default)
# the longest sequence the JAX package gives its fused prenorm-MHSA kernel
# (blocks.py:210-224): the TPU kernel holds a whole (N, N) score matrix in
# VMEM. The port keeps it as the cap of joint attention at the head dims
# whose attention stage in B1/B3 is the CUDA-core kernel, which B5/B6
# outrun at long N (``fuses_joint``)
FUSED_MHSA_MAX_N = 2048


def fuses_joint(N, hd):
    """Whether joint attention over N tokens at head dim hd is one fused
    prenorm-MHSA call (B1 forward, B3 backward): up to FUSED_MHSA_MAX_N
    tokens as in the JAX package, and at every length where both
    directions' attention stage is the long variant (head dim 64, B5's and
    B6's kernels in place on qkv, memory linear in N), where the port
    departs from the JAX package's unfused branch: the card has no VMEM
    cap, and the fused call folds the LayerNorm, runs qkv and the
    projection on its own products and copies no layout."""
    return N <= FUSED_MHSA_MAX_N or (
        fused_mhsa.attention_variant(N, hd) == "long"
        == fused_mhsa.attention_bwd_variant(N, hd))


def get_sine_cosine_pos_emb(n_position, d_hid):
    """Sinusoid position table (1, n_position, d_hid) in fp32, computed in
    float64 like the reference (transformer.py:12-22)."""
    position = np.arange(n_position)[:, None]
    hid = np.arange(d_hid)[None, :]
    angle = position / np.power(10000, 2 * (hid // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return torch.tensor(table[None], dtype=torch.float32)


def drop_path(x, rate, generator, mesh=None, clips=None):
    """Stochastic depth per leading-axis row (blocks.py:61-79):
    ``x / keep · floor(keep + U)``, U uniform in the working type, this
    rank's rows of the global draw under ``mesh`` (``clips``: rows of
    (clip, k) with k split over the seq ranks, ``mesh.rand_rows``)."""
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    u = _mesh.rand_rows(shape, generator, x.dtype, x.device, mesh, clips)
    return x / keep * torch.floor(keep + u)


class DropPath(nn.Module):
    """Stochastic depth at ``rate``; the identity in eval mode or at 0."""

    def __init__(self, rate=0.0, mesh=None):
        super().__init__()
        self.rate = float(rate)
        self.mesh = mesh

    def forward(self, x, generator=None, clips=None):
        if not self.training or self.rate == 0.0:
            return x
        if clips is None:  # a row a clip, the same on every seq rank
            return drop_path(x, self.rate, generator, self.mesh)
        return drop_path(x, self.rate, generator, self.mesh, clips)


def _reset_layer_norm(norm):
    init.ones_(norm.weight)
    init.zeros_(norm.bias)


SEQ_LAYOUTS = ("tokens", "frames", "replicated")


def _refuse_sharded(module):
    if module.tp > 1:
        raise RuntimeError(
            f"{type(module).__name__} holds a tp={module.tp} shard: "
            "initialise the full model and load its shard "
            "(parallel.tp.shard_state_dict)")


class Attention(nn.Module):
    """Parameter holder of the fused-QKV MHSA (names ``qkv``, ``proj``); the
    computation is ``fused_mhsa.fused_prenorm_mhsa``. At ``tp`` > 1 it holds
    one model rank's heads: qkv (3·dim/tp, dim), proj (dim, dim/tp)."""

    def __init__(self, dim, num_heads, tp=1):
        super().__init__()
        if num_heads % tp:
            raise ValueError(f"tp={tp} does not divide {num_heads} heads")
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.tp = tp
        self.qkv = nn.Linear(dim, 3 * dim // tp)
        self.proj = nn.Linear(dim // tp, dim)

    def reset_parameters(self, generator):
        _refuse_sharded(self)
        init.torch_linear_(self.qkv, generator)
        init.torch_linear_(self.proj, generator)

    def forward(self, x):
        """JAX ``Attention.__call__(need_weights=True)`` (blocks.py:153-183)
        on the normalised x (B, N, dim): the qkv product, the fp32 weights
        softmax(q kᵀ·scale), their product with v in the working type, the
        projection. Returns (out (B, N, dim), weights (B, H, N, N) fp32)."""
        if self.tp > 1:
            raise NotImplementedError(
                f"attention weights of a tp={self.tp} shard: this rank holds "
                f"{self.num_heads // self.tp} of {self.num_heads} heads")
        B, N, _ = x.shape
        dt, hd = x.dtype, self.head_dim
        qkv = F.linear(x, self.qkv.weight.to(dt), self.qkv.bias.to(dt))
        q, k, v = qkv.reshape(B, N, 3, self.num_heads, hd).permute(
            2, 0, 3, 1, 4).unbind(0)
        weights = torch.softmax(
            torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5,
            dim=-1)
        o = torch.matmul(weights.to(dt).float(), v.float()).to(dt)
        out = F.linear(o.transpose(1, 2).reshape(B, N, self.num_heads * hd),
                       self.proj.weight.to(dt), self.proj.bias.to(dt))
        return out, weights


class _SeqLayout:
    """The seq ranks of the block's mesh and its stack's ``seq_layout``
    (module doc)."""

    def _set_layout(self, mesh, num_frames, seq_layout):
        if seq_layout not in SEQ_LAYOUTS:
            raise ValueError(f"seq_layout {seq_layout!r} not in "
                             f"{SEQ_LAYOUTS}")
        self.sp = _mesh.seq_ranks(mesh)
        self.num_frames = num_frames
        self.seq_layout = seq_layout
        if self.sp > 1 and seq_layout == "frames":
            _sp.check_divides("frames", num_frames, mesh)

    def _clips(self, x):
        """DropPath's ``clips`` for rows x of the ``frames`` layout (None:
        one row a clip, the same draw on every seq rank)."""
        if self.sp > 1 and self.seq_layout == "frames":
            return x.shape[0] // (self.num_frames // self.sp)
        return None


class _PrenormMHSA(nn.Module, _SeqLayout):
    """LayerNorm + Attention, run as one fused prenorm-MHSA call, then
    DropPath on its output."""

    def __init__(self, embed_dims, num_heads, drop_path_rate=0.0,
                 mesh=None, num_frames=None, seq_layout="tokens"):
        super().__init__()
        self.mesh = mesh
        self._set_layout(mesh, num_frames, seq_layout)
        self.norm = nn.LayerNorm(embed_dims, eps=LN_EPS)
        self.attn = Attention(embed_dims, num_heads, _mesh.model_ranks(mesh))
        self.layer_drop = DropPath(drop_path_rate, mesh)

    def reset_parameters(self, generator):
        _reset_layer_norm(self.norm)
        self.attn.reset_parameters(generator)

    def _sharded(self, fn, x, ln_dtype=None):
        """``fn`` over x and the block's weights in x's dtype (the LayerNorm
        weight and bias in ``ln_dtype``, x's by default), through
        ``tp.sharded_call``."""
        a, dt = self.attn, x.dtype
        ln = ln_dtype or dt
        return _tp.sharded_call(
            fn, self.mesh, x.contiguous(), self.norm.weight.to(ln),
            self.norm.bias.to(ln), a.qkv.weight.to(dt), a.qkv.bias.to(dt),
            a.proj.weight.to(dt), a.proj.bias.to(dt))

    def _fused(self, x, ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj,
               block_diag=0):
        """B1 over x's rows with the block's (shard's) weights."""
        hd = self.attn.head_dim
        # the heads of this shard, from its width (JAX blocks.py:306)
        return fused_mhsa.fused_prenorm_mhsa(
            x, ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj,
            w_qkv.shape[0] // (3 * hd), hd ** -0.5, LN_EPS, False,
            block_diag)

    def _prenorm_mhsa(self, x, generator, block_diag=0, clips=None):
        """B1 over x's rows, then DropPath (``clips``: the rows' clips
        under sequence parallelism, ``_clips`` by default)."""
        out = self._sharded(
            lambda *a: self._fused(*a, block_diag=block_diag), x)
        return self.layer_drop(out, generator,
                               self._clips(x) if clips is None else clips)

    def _weights(self, x):
        """The attention weights of x's rows: LayerNorm (fp32 statistics,
        the working type), then ``Attention.forward``."""
        if self.sp > 1:
            raise NotImplementedError(
                f"attention weights of a sequence-parallel shard (sp="
                f"{self.sp}): this rank holds part of the tokens")
        return self.attn(layer_norm(x, self.norm.weight, self.norm.bias,
                                    LN_EPS))[1]


class JointAttention(_PrenormMHSA):
    """Prenorm joint space-time MHSA with the residual (blocks.py:453-522):
    every token of the clip attends to every other, DropPath per sample.

    Where ``fuses_joint`` says so it is one fused prenorm-MHSA call (B1
    forward, B3 backward): up to FUSED_MHSA_MAX_N tokens, as in the JAX
    package from N = 64 (the port sends N < 64 there too, the
    fact_encoder's temporal stack, N = 9, where the JAX package takes a
    VPU path that is not ported), and at head dim 64 at every length (32
    frames of ViViT-B, N = 3137, where the JAX package goes unfused: its
    cap is the TPU's VMEM, and B1/B3's long variant runs B5's and B6's
    kernels in place, in memory linear in N). Otherwise the JAX package's
    unfused ``Attention``: LayerNorm (fp32 statistics), the qkv product,
    flash attention (B5 forward, B6 backward) on (B, H, N, hd), the
    projection. The two forms differ in one rounding: the fused call
    takes the LayerNorm's weight and bias in the working type, as every
    fused call of the port does. Under sequence parallelism in the
    ``tokens`` layout, ``sp.ring_prenorm_mhsa`` over the rank's tokens,
    the cls row shared (blocks.py:475-493); in the others each rank's
    rows are whole. While a profiler session is active the fused and the
    unfused forward record the span ``attention.fused`` or
    ``attention.unfused`` (``utils/profiling.py``), with its device time
    on a card."""

    def forward(self, query, generator=None, return_attention=False):
        if return_attention:
            return self._weights(query)
        if self.sp > 1 and self.seq_layout == "tokens":
            out = self._sharded(self._ring, query)
            return query + self.layer_drop(out, generator)
        if fuses_joint(query.shape[1], self.attn.head_dim):
            with profiling.span("attention.fused", device=query.device):
                out = self._sharded(self._fused, query)
        else:
            with profiling.span("attention.unfused", device=query.device):
                out = self._sharded(self._unfused, query,
                                    self.norm.weight.dtype)
        return query + self.layer_drop(out, generator, self._clips(query))

    def _ring(self, x, ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj):
        hd = self.attn.head_dim
        return _sp.ring_prenorm_mhsa(x, ln_w, ln_b, w_qkv, b_qkv, w_proj,
                                     b_proj, hd, hd ** -0.5, LN_EPS,
                                     self.mesh, shared=1)

    def _unfused(self, x, ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj):
        B, N, _ = x.shape
        hd = self.attn.head_dim
        heads = w_qkv.shape[0] // (3 * hd)  # this shard's
        xn = layer_norm(x, ln_w, ln_b, LN_EPS)
        qkv = F.linear(xn, w_qkv, b_qkv)
        q, k, v = qkv.reshape(B, N, 3, heads, hd).permute(
            2, 0, 3, 1, 4).contiguous().unbind(0)
        o = flash_attention.flash_attention(q, k, v, hd ** -0.5)
        o = o.transpose(1, 2).reshape(B, N, heads * hd)
        return F.linear(o, w_proj, b_proj)


class DividedTemporalAttention(_PrenormMHSA):
    """Temporal half of divided space-time attention (blocks.py:227-344).

    Strip the cls token, fold ``b (p t) d -> (b p) t d`` (a pure reshape of
    the patch-major layout), prenorm MHSA over each length-t row, DropPath
    per row, then ``temporal_fc`` (zero-initialised) when the cls token is
    absent, the residual, and the cls token re-attached. Each length-t row
    is its own sequence: the kernel's ``block_diag`` mode with T = the row
    length. Under sequence parallelism the rows are this rank's patches',
    whole, and a cls mean over patches sums over the seq group."""

    def __init__(self, embed_dims, num_heads, num_frames, use_cls_token,
                 drop_path_rate=0.0, mesh=None, seq_layout="tokens"):
        super().__init__(embed_dims, num_heads, drop_path_rate, mesh,
                         num_frames, seq_layout)
        _refuse_layout(self)
        self.use_cls_token = use_cls_token
        if not use_cls_token:
            self.temporal_fc = nn.Linear(embed_dims, embed_dims)

    def reset_parameters(self, generator):
        super().reset_parameters(generator)
        if not self.use_cls_token:
            init.zeros_(self.temporal_fc.weight)
            init.zeros_(self.temporal_fc.bias)

    def forward(self, query, generator=None, return_attention=False):
        cls_token = query[:, :1]
        patches = query[:, 1:]
        b, n, d = patches.shape
        t = self.num_frames
        p = n // t
        x = patches.reshape(b * p, t, d)
        if self.use_cls_token:
            cls_rep = cls_token[:, None].expand(b, p, 1, d).reshape(b * p, 1, d)
            x = torch.cat([cls_rep, x], dim=1)
        if return_attention:
            return self._weights(x)
        attn_out = self._prenorm_mhsa(x, generator, block_diag=x.shape[1],
                                      clips=b if self.sp > 1 else None)
        if self.use_cls_token:
            new_cls = _sp.seq_mean(attn_out[:, 0].reshape(b, p, d),
                                   self.mesh)
            out = torch.cat([new_cls, attn_out[:, 1:].reshape(b, p * t, d)],
                            dim=1)
            return query + out
        fc = self.temporal_fc
        attn_out = F.linear(attn_out, fc.weight.to(query.dtype),
                            fc.bias.to(query.dtype))
        return torch.cat([cls_token, patches + attn_out.reshape(b, p * t, d)],
                         dim=1)


class DividedSpatialAttention(_PrenormMHSA):
    """Spatial half of divided space-time attention (blocks.py:347-450):
    fold ``b (p t) d -> (b t) p d``; the cls token, when present, is
    replicated per frame, attends with the patches, and is averaged back
    over frames. DropPath is per length-p (or p + 1) row. Under sequence
    parallelism the fold goes through the all-to-all to this rank's frames
    and back (``sp.to_frames``, ``sp.to_patches``), and the cls mean over
    frames sums over the seq group."""

    def __init__(self, embed_dims, num_heads, num_frames, use_cls_token,
                 drop_path_rate=0.0, mesh=None, seq_layout="tokens"):
        super().__init__(embed_dims, num_heads, drop_path_rate, mesh,
                         num_frames, seq_layout)
        _refuse_layout(self)
        self.use_cls_token = use_cls_token

    def forward(self, query, generator=None, return_attention=False):
        cls_token = query[:, :1]
        patches = query[:, 1:]
        b, n, d = patches.shape
        t = self.num_frames
        p = n // t
        x = _sp.to_frames(patches.reshape(b, p, t, d), self.mesh)
        p, t = x.shape[1], x.shape[2]  # every patch, this rank's frames
        x = x.transpose(1, 2).reshape(b * t, p, d)
        if self.use_cls_token:
            cls_rep = cls_token[:, None].expand(b, t, 1, d).reshape(b * t, 1, d)
            x = torch.cat([cls_rep, x], dim=1)
        if return_attention:
            return self._weights(x)
        attn_out = self._prenorm_mhsa(x, generator,
                                      clips=b if self.sp > 1 else None)
        if self.use_cls_token:
            new_cls = _sp.seq_mean(attn_out[:, 0].reshape(b, t, d),
                                   self.mesh)
            attn_out = attn_out[:, 1:]
        out = _sp.to_patches(attn_out.reshape(b, t, p, d).transpose(1, 2),
                             self.mesh)
        out = out.reshape(b, -1, d)
        if self.use_cls_token:
            return query + torch.cat([new_cls, out], dim=1)
        return torch.cat([cls_token, patches + out], dim=1)


def _refuse_layout(module):
    if module.sp > 1 and module.seq_layout != "tokens":
        raise ValueError(f"{type(module).__name__} runs sequence-parallel "
                         f"in the tokens layout only, not "
                         f"{module.seq_layout!r}")


class FFN(nn.Module, _SeqLayout):
    """Prenorm MLP with residual (blocks.py:525-603), two layers, run as one
    fused prenorm-FFN call, DropPath per sample on its output. ``layers``
    keeps the reference's layout: ``Sequential(Linear)`` then a bare
    ``Linear``. Under sequence parallelism it runs on this rank's tokens
    (or rows), the cls row among them."""

    def __init__(self, embed_dims, hidden_channels, drop_path_rate=0.0,
                 mesh=None, num_frames=None, seq_layout="tokens"):
        super().__init__()
        tp = _mesh.model_ranks(mesh)
        if hidden_channels % tp:
            raise ValueError(f"tp={tp} does not divide hidden "
                             f"{hidden_channels}")
        self.tp, self.mesh = tp, mesh
        self._set_layout(mesh, num_frames, seq_layout)
        self.norm = nn.LayerNorm(embed_dims, eps=LN_EPS)
        self.layers = nn.ModuleList([
            nn.Sequential(nn.Linear(embed_dims, hidden_channels // tp)),
            nn.Linear(hidden_channels // tp, embed_dims),
        ])
        self.layer_drop = DropPath(drop_path_rate, mesh)

    def reset_parameters(self, generator):
        _refuse_sharded(self)
        _reset_layer_norm(self.norm)
        init.torch_linear_(self.layers[0][0], generator)
        init.torch_linear_(self.layers[1], generator)

    def forward(self, x, generator=None):
        fc1, fc2 = self.layers[0][0], self.layers[1]
        dt = x.dtype
        out = _tp.sharded_call(
            lambda *a: fused_ffn.fused_prenorm_ffn(*a, LN_EPS), self.mesh,
            x.contiguous(), self.norm.weight.to(dt), self.norm.bias.to(dt),
            fc1.weight.to(dt), fc1.bias.to(dt), fc2.weight.to(dt),
            fc2.bias.to(dt))
        return x + self.layer_drop(out, generator, self._clips(x))


class BasicTransformerBlock(nn.Module):
    """One block assembled from ``operator_order`` (blocks.py:606-691):
    ``self_attn`` (joint), ``time_attn`` and ``space_attn`` (divided),
    ``ffn``, with ``use_cls_token = (i == len(operator_order) - 2)``: only
    the divided attention just before the FFN carries the cls token.
    ``seq_layout``: the stack's, under sequence parallelism (module
    doc)."""

    def __init__(self, embed_dims, num_heads, num_frames, hidden_channels,
                 operator_order, drop_path_rate=0.0, mesh=None,
                 seq_layout="tokens"):
        super().__init__()
        attentions, ffns = [], []
        order = tuple(operator_order)
        kinds = {"time_attn": DividedTemporalAttention,
                 "space_attn": DividedSpatialAttention}
        for i, op in enumerate(order):
            if op in kinds:
                attentions.append(kinds[op](
                    embed_dims, num_heads, num_frames,
                    use_cls_token=(i == len(order) - 2),
                    drop_path_rate=drop_path_rate, mesh=mesh,
                    seq_layout=seq_layout))
            elif op == "self_attn":
                attentions.append(JointAttention(
                    embed_dims, num_heads, drop_path_rate, mesh, num_frames,
                    seq_layout))
            elif op == "ffn":
                ffns.append(FFN(embed_dims, hidden_channels, drop_path_rate,
                                mesh, num_frames, seq_layout))
            else:
                raise TypeError(f"Unsupported operator type {op}")
        self.attentions = nn.ModuleList(attentions)
        self.ffns = nn.ModuleList(ffns)

    def reset_parameters(self, generator):
        for m in (*self.attentions, *self.ffns):
            m.reset_parameters(generator)

    def forward(self, x, generator=None, return_attention=False):
        """x through the attentions and the FFN; with ``return_attention``
        the last attention's weights, and no FFN (blocks.py:685-687)."""
        for i, layer in enumerate(self.attentions):
            if return_attention and i == len(self.attentions) - 1:
                return layer(x, generator, return_attention=True)
            x = layer(x, generator)
        for layer in self.ffns:
            x = layer(x, generator)
        return x


def checkpointed(block, x, generator):
    """``block(x, generator)`` under ``torch.utils.checkpoint`` (module
    doc): the backward's second forward draws from ``generator`` set back
    to its state before the block (``get_state``/``set_state``), which is
    then returned to the state it had. ``torch.utils.checkpoint`` restores
    only the default generators, and DropPath draws from the explicit one;
    with no generator it draws from the default one, whose state the
    checkpoint then keeps."""
    state = None if generator is None else generator.get_state()
    calls = []

    def run(x):
        if not calls or generator is None:
            calls.append(True)
            return block(x, generator)
        now = generator.get_state()  # the backward's second forward
        generator.set_state(state)
        try:
            return block(x, generator)
        finally:
            generator.set_state(now)

    return checkpoint(run, x, use_reentrant=False,
                      preserve_rng_state=generator is None)


class TransformerContainer(nn.Module):
    """Stack of BasicTransformerBlocks (blocks.py:694-740) with the DropPath
    rate of layer i at ``linspace(0, drop_path_rate, depth)[i]``; ``remat``
    checkpoints each block while autograd records (module doc);
    ``seq_layout`` is the stack's under sequence parallelism."""

    def __init__(self, num_transformer_layers, embed_dims, num_heads,
                 num_frames, hidden_channels, operator_order,
                 drop_path_rate=0.0, mesh=None, remat=False,
                 seq_layout="tokens"):
        super().__init__()
        self.remat = remat
        dpr = np.linspace(0, drop_path_rate, num_transformer_layers)
        self.layers = nn.ModuleList([
            BasicTransformerBlock(embed_dims, num_heads, num_frames,
                                  hidden_channels, operator_order,
                                  float(dpr[i]), mesh, seq_layout)
            for i in range(num_transformer_layers)])

    def reset_parameters(self, generator):
        for layer in self.layers:
            layer.reset_parameters(generator)

    def forward(self, x, generator=None, return_attention=False):
        """x through the blocks; with ``return_attention`` the last
        block's attention weights, no block checkpointed (blocks.py:717,
        734-735)."""
        remat = self.remat and not return_attention and \
            torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if return_attention and i == len(self.layers) - 1:
                return layer(x, generator, return_attention=True)
            x = checkpointed(layer, x, generator) if remat \
                else layer(x, generator)
        return x


def last_selfattention(model, x):
    """``model(x, return_attention=True)`` in eval mode, as the JAX
    models' ``get_last_selfattention`` runs with ``deterministic=True``
    (no DropPath, no dropout); the model's mode is restored after."""
    training = model.training
    model.eval()
    try:
        return model(x, return_attention=True)
    finally:
        model.train(training)


class _PatchProjection(nn.Module):
    """Conv-shaped weight, (out, in, kh, kw) or (out, in, kt, kh, kw),
    applied as one matmul: with kernel == stride the convolution is a
    reshape and a product."""

    def __init__(self, in_channels, embed_dims, kernel):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            embed_dims, in_channels, *kernel))
        self.bias = nn.Parameter(torch.empty(embed_dims))

    def reset_parameters(self, generator):
        init.kaiming_normal_fan_in_relu_(self.weight, generator)
        init.zeros_(self.bias)

    def forward(self, patches):
        w = self.weight.reshape(self.weight.shape[0], -1)
        return F.linear(patches, w.to(patches.dtype),
                        self.bias.to(patches.dtype))


class PatchEmbed(nn.Module):
    """Patch embedding (blocks.py:769-815): ``Conv2d``, per-frame ps x ps
    patches, (b, t, c, h, w) -> (b·t, gh·gw, embed_dims); ``Conv3d``,
    tube_size x ps x ps tubelets, -> (b·t/tube_size, gh·gw, embed_dims)."""

    def __init__(self, img_size, patch_size, in_channels=3, embed_dims=768,
                 tube_size=2, conv_type="Conv2d"):
        super().__init__()
        if conv_type not in ("Conv2d", "Conv3d"):
            raise TypeError(f"Unsupported conv layer type {conv_type}")
        self.img_size = img_size
        self.patch_size = patch_size
        self.tube_size = tube_size if conv_type == "Conv3d" else 1
        kernel = (patch_size, patch_size)
        if conv_type == "Conv3d":
            kernel = (tube_size,) + kernel
        self.projection = _PatchProjection(in_channels, embed_dims, kernel)

    @property
    def num_patches(self):
        return (self.img_size // self.patch_size) ** 2

    def reset_parameters(self, generator):
        self.projection.reset_parameters(generator)

    def forward(self, x, keep=None):
        """``keep``: the slice of the (raster-order) patches to embed, all
        of them by default (a sequence-parallel rank's, ``sp.shard``)."""
        b, t, c, h, w = x.shape
        ps, tt = self.patch_size, self.tube_size
        gh, gw, gt = h // ps, w // ps, t // tt
        # (b gt, tt, c, gh, ps, gw, ps) -> (b gt, gh gw, c·tt·ps·ps), the
        # flattening order of the conv weight's (in, [kt,] kh, kw)
        x = x.reshape(b * gt, tt, c, gh, ps, gw, ps).permute(
            0, 3, 5, 2, 1, 4, 6)
        x = x.reshape(b * gt, gh * gw, c * tt * ps * ps)
        return self.projection(x if keep is None else x[:, keep])


class ClassificationHead(nn.Module):
    """Linear classifier head (blocks.py:820-844)."""

    def __init__(self, num_classes, in_channels):
        super().__init__()
        self.cls_head = nn.Linear(in_channels, num_classes)

    def reset_parameters(self, generator):
        init.trunc_normal_(self.cls_head.weight, generator, std=0.02)
        init.zeros_(self.cls_head.bias)

    def forward(self, x):
        fc = self.cls_head
        return F.linear(x, fc.weight.to(x.dtype), fc.bias.to(x.dtype))
