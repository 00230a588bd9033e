"""Pipeline parallelism: the transformer blocks split by depth over the pipe
ranks of a mesh, run as a GPipe schedule of microbatches.

Port of ``videotransformer_tpu/parallel/pp.py``. JAX stacks the L
per-layer parameter subtrees on a leading axis sharded over ``pipe``
(pp.py:46-69) and differentiates through a ``shard_map`` of ticks with one
``ppermute`` each (pp.py:71-162). Here each pipe rank is a process that
holds its stage only:

- ``Stage(model, mesh)`` cuts a model built whole (and initialised whole,
  so every stage draws the one-process initialisation) down to what pipe
  rank p holds: the blocks of layers ``[p·L/P, (p+1)·L/P)`` under their
  global names (``transformer_layers.layers.{i}....``, a ``ModuleDict``),
  on stage 0 also the embedding (patch embed, cls token, position and time
  tables), on the last stage the final norm. No parameter is replicated
  over the pipe ranks (JAX replicates those outside the blocks; the
  numbers are the same). So no stacking is needed: ``stage_state_dict``
  cuts a canonical state dict to a stage, ``gather_stages`` puts the
  stages' parts together again (pp.py's ``stack`` / ``unstack`` /
  ``shard_stacked_params``);
- ``pipeline_forward`` runs every microbatch in order: stage p receives
  it from p - 1 (stage 0 from ``prepare_tokens``), runs its blocks on it
  as a leaf of its own graph, and sends the output to p + 1;
  ``pipeline_backward`` runs the microbatches in reverse: the last stage
  seeds each output's gradient from its loss, every other stage receives
  it from p + 1 and calls ``torch.autograd.backward``, and the gradient of
  each input leaf goes to p - 1. Weight gradients accumulate in ``.grad``
  over the microbatches: JAX's exact GPipe backward. Forward-all then
  backward-all is acyclic, so the blocking moves of ``parallel/mesh.py``
  (``send_stage``/``recv_stage``) are called in the same order at both
  ends of every pair;
- the rows split into microbatches as JAX's trainer splits them
  (pp_trainer.py:85-88): row r in microbatch r % M (JAX's
  ``pipelined_forward_features`` splits contiguously; without randomness
  the result is the same either way). A microbatch of no rows (an eval
  batch of fewer rows than M) is skipped on every stage;
- DropPath: one process draws, layer by layer, each block's uniforms for
  the global batch (``mesh.rand_rows``). Stage p never runs the layers
  before it, so every stage makes every layer's draws from the step's
  generator in that order, keeps its own layers' and drops the rest
  (``Stage.drop_path_draws``), and each microbatch's blocks take their
  rows of them (``RowDraws``). The draws are those of one process on the
  global batch, so a pipelined step is held against one process. JAX
  folds a key per (layer, microbatch) instead (pp_trainer.py:103-104): a
  different random stream, the same distribution;
- ``pipelined_forward_features`` is the depth-sharded forward for
  inference (pp.py:165-217): ``prepare_tokens`` on stage 0, the blocks
  pipelined, then the model's ``finish`` (the space-only frame mean, the
  final norm, the readout) on the last stage, which returns the features
  (the others return None).

The stages' activations move in the working dtype (bf16 under
``-use_fp16``), as JAX's ``ppermute`` moves them. Scope, as in JAX: the
one homogeneous block stack of TimeSformer (divided, joint, space-only)
and ViViT (joint, divided); the trainer refuses the rest
(``training/stacked_trainer.py``).
"""

import math

import torch
import torch.distributed as dist
from torch import nn

from videotransformer_tpu_torch.ops.blocks import (
    DividedSpatialAttention, DividedTemporalAttention, checkpointed)
from videotransformer_tpu_torch.parallel import mesh as _mesh

LAYER_PREFIX = "transformer_layers.layers."


def stage_bounds(num_layers, stages, stage):
    """The layers [lo, hi) that pipe rank ``stage`` of ``stages`` runs."""
    per = num_layers // stages
    return stage * per, (stage + 1) * per


def stage_of(name, num_layers, stages):
    """The pipe rank that holds the model parameter ``name`` (a canonical
    state-dict key): a block's by its layer, the final norm the last,
    everything before the blocks stage 0."""
    if name.startswith(LAYER_PREFIX):
        layer = int(name[len(LAYER_PREFIX):].split(".")[0])
        return layer // (num_layers // stages)
    if name.startswith("norm."):
        return stages - 1
    return 0


def stage_state_dict(state, num_layers, stages, stage):
    """The entries of the canonical model state ``state`` that pipe rank
    ``stage`` holds, under their global names."""
    return {k: v for k, v in state.items()
            if stage_of(k, num_layers, stages) == stage}


def gather_stages(local, layout, mesh):
    """The whole state on every pipe rank of ``mesh``: ``layout`` lists
    (name, shape, dtype, pipe rank that holds it) in the canonical order,
    ``local`` this rank's entries. Each stage's entries go out in one
    broadcast a dtype over the pipe group, the bits its own."""
    parts = {}
    for q in range(mesh.pipe):
        held = [(n, shape, dt) for n, shape, dt, owner in layout
                if owner == q]
        for dtype in dict.fromkeys(dt for _, _, dt in held):
            same = [(n, shape) for n, shape, dt in held if dt == dtype]
            sizes = [math.prod(shape) for _, shape in same]
            if q == mesh.pipe_rank:
                flat = torch.cat([local[n].detach().reshape(-1).to(
                    mesh.device) for n, _ in same])
            else:
                flat = torch.empty(sum(sizes), dtype=dtype,
                                   device=mesh.device)
            dist.broadcast(flat, src=mesh.pipe_ranks[q],
                           group=mesh.pipe_group)
            for (n, shape), v in zip(same, flat.split(sizes)):
                parts[n] = v.view(shape)
    return {n: parts[n] for n, *_ in layout}


def split_rows(x, microbatches):
    """``x``'s rows in ``microbatches`` parts: row r in part r % M."""
    return [x[m::microbatches] for m in range(microbatches)]


def merge_rows(parts):
    """The inverse of ``split_rows`` (a part may be None: no rows)."""
    held = [p for p in parts if p is not None]
    out = held[0].new_empty((sum(p.shape[0] for p in held),)
                            + tuple(held[0].shape[1:]))
    for m, p in enumerate(parts):
        if p is not None:
            out[m::len(parts)] = p
    return out


class RowDraws:
    """One layer's DropPath uniforms for one microbatch, in place of the
    generator its blocks are given: each ``rand_rows`` (what
    ``mesh.rand_rows`` asks of a generator that is not a torch.Generator)
    hands out the next draw of the layer, made for ``total`` token rows of
    the global batch, cut to the microbatch's token rows ``rows``.
    ``get_state``/``set_state``, a torch.Generator's, let ``ops/blocks.py::
    checkpointed`` replay a block's draws in the backward."""

    def __init__(self, draws, rows, total):
        self.draws, self.rows, self.total = draws, rows, total
        self.pos = 0

    def rand_rows(self, shape, dtype, device):
        u = self.draws[self.pos]
        self.pos += 1
        if u.dtype != dtype or u.device != torch.device(device):
            raise ValueError(f"drawn {u.dtype} on {u.device}, asked "
                             f"{dtype} on {device}")
        return u.reshape(self.total, -1)[self.rows].reshape(shape)

    def get_state(self):
        return self.pos

    def set_state(self, pos):
        self.pos = pos


class Stage:
    """Pipe rank ``mesh.pipe_rank``'s part of ``model`` (a TimeSformer or
    ViViT with one block stack, built and initialised whole), which it
    cuts in place (module doc). Keeps what the schedule needs of the whole
    model: the layer count, every layer's DropPath rate, the rows of a
    block's draws and the token geometry, and ``layout``, the canonical
    model state's (name, shape, dtype, pipe rank holding it)."""

    def __init__(self, model, mesh):
        container = model.transformer_layers
        layers = container.layers
        L, P, p = len(layers), mesh.pipe, mesh.pipe_rank
        if L % P:
            raise ValueError(f"pipeline parallelism needs the layer count "
                             f"divisible by -pp: {L} layers over {P} stages")
        self.model, self.mesh, self.num_layers = model, mesh, L
        self.first, self.last = p == 0, p == P - 1
        self.lo, self.hi = stage_bounds(L, P, p)
        self.layout = [(k, v.shape, v.dtype, stage_of(k, L, P))
                       for k, v in model.state_dict().items()]
        # every block has the same modules; a rate for all of a block's
        self.rates = [b.ffns[0].layer_drop.rate for b in layers]
        self._draw_kinds = [
            (type(m), getattr(m, "num_frames", None))
            for m in (*layers[0].attentions, *layers[0].ffns)]
        self.remat = container.remat
        self.patch_size = model.patch_embed.patch_size
        self.tube_size = model.patch_embed.tube_size
        self.dims = model.cls_token.shape[-1]
        self.space_only = model.attention_type == "space_only"
        self.blocks = [(i, layers[i]) for i in range(self.lo, self.hi)]
        container.layers = nn.ModuleDict({str(i): b for i, b in self.blocks})
        outside = [n for n, _ in model.named_children()] + \
            [n for n, _ in model.named_parameters(recurse=False)]
        for name in outside:
            if name != "transformer_layers" and \
                    stage_of(name + ".", L, P) != p:
                delattr(model, name)

    def own(self, state):
        """This stage's entries of the canonical model state ``state``."""
        return stage_state_dict(state, self.num_layers, self.mesh.pipe,
                                self.mesh.pipe_rank)

    def tokens_shape(self, video_shape):
        """The (rows, tokens, width) of ``prepare_tokens`` on a clip batch
        of ``video_shape`` (b, t, c, h, w): (b·t, 1 + p, d) space-only,
        else (b, 1 + p·t / tube, d)."""
        b, t, _, h, w = video_shape
        patches = (h // self.patch_size) * (w // self.patch_size)
        if self.space_only:
            return (b * t, 1 + patches, self.dims)
        return (b, 1 + patches * (t // self.tube_size), self.dims)

    def draw_rows(self, tokens):
        """The rows of each of a block's DropPath draws (its attentions',
        then its FFN's) a token row of ``tokens`` tokens: a temporal
        attention's (clip, patch) rows, a spatial one's (clip, frame) rows,
        one row a clip elsewhere (ops/blocks.py)."""
        rows = []
        for kind, frames in self._draw_kinds:
            if kind is DividedTemporalAttention:
                rows.append((tokens - 1) // frames)
            elif kind is DividedSpatialAttention:
                rows.append(frames)
            else:
                rows.append(1)
        return rows

    def drop_path_draws(self, generator, rows, tokens, dtype, device):
        """Every layer's DropPath uniforms for ``rows`` token rows of the
        global batch of ``tokens`` tokens, drawn from ``generator`` as one
        process draws them (layer by layer, a layer at rate 0 not at all):
        {layer: [draws]} of this stage's layers; the others' are drawn and
        dropped."""
        per_row = self.draw_rows(tokens)
        out = {}
        for i, rate in enumerate(self.rates):
            if rate == 0.0:
                continue
            draws = [torch.rand((rows * k, 1, 1), generator=generator,
                                dtype=dtype, device=device) for k in per_row]
            if self.lo <= i < self.hi:
                out[i] = draws
        return out


def run_blocks(stage, x, draws=None):
    """``x`` through the stage's blocks in order, layer i's DropPath taking
    ``draws[i]`` (a ``RowDraws``); each block checkpointed under ``remat``
    while autograd records (``ops/blocks.py::checkpointed``)."""
    remat = stage.remat and torch.is_grad_enabled()
    for i, block in stage.blocks:
        g = None if draws is None else draws.get(i)
        x = checkpointed(block, x, g) if remat else block(x, g)
    return x


def pipeline_forward(stage, inputs, shapes, dtype, draws=None):
    """The forward half of the schedule on this stage: microbatch m of
    ``shapes[m]`` (stage 0: ``inputs[m]``; else received from the stage
    before) through the stage's blocks (``draws[m]``: its DropPath draws,
    {layer: RowDraws}), the output sent to the stage after. While autograd
    records, each input is a leaf of its own graph. Returns [(input,
    output)], None for a microbatch of no rows."""
    mesh, p = stage.mesh, stage.mesh.pipe_rank
    grad = torch.is_grad_enabled()
    saved = []
    for m, shape in enumerate(shapes):
        if shape[0] == 0:
            saved.append(None)
            continue
        x = inputs[m] if stage.first else \
            _mesh.recv_stage(shape, dtype, mesh, p - 1)
        if grad:
            x = x.detach().requires_grad_()
        y = run_blocks(stage, x, None if draws is None else draws[m])
        if not stage.last:
            _mesh.send_stage(y.detach(), mesh, p + 1)
        saved.append((x, y))
    return saved


def pipeline_backward(stage, saved, d_outs=None):
    """The backward half: microbatches in reverse order, each output's
    gradient ``d_outs[m]`` on the last stage, else received from the stage
    after; the gradient of each input sent to the stage before. Returns
    the inputs' gradients (stage 0's, for ``prepare_tokens``)."""
    mesh, p = stage.mesh, stage.mesh.pipe_rank
    grads = [None] * len(saved)
    for m in reversed(range(len(saved))):
        if saved[m] is None:
            continue
        x, y = saved[m]
        g = d_outs[m] if stage.last else \
            _mesh.recv_stage(y.shape, y.dtype, mesh, p + 1)
        torch.autograd.backward(y, g)
        if not stage.first:
            _mesh.send_stage(x.grad, mesh, p - 1)
        grads[m] = x.grad
    return grads


def microbatch_shapes(tokens_shape, microbatches):
    """The shape of each ``split_rows`` part of tokens of ``tokens_shape``
    (every stage knows them; none is sent)."""
    rows, rest = tokens_shape[0], tuple(tokens_shape[1:])
    return [(len(range(m, rows, microbatches)),) + rest
            for m in range(microbatches)]


@torch.no_grad()
def pipelined_forward_features(stage, video, microbatches=4):
    """The features of clips ``video`` (b, t, c, h, w; every stage is
    given the batch, stage 0 embeds it) through the pipeline, in eval mode:
    (b, d) on the last stage, None on the others."""
    model = stage.model
    training = model.training
    model.eval()
    try:
        shape = stage.tokens_shape(video.shape)
        parts = split_rows(model.prepare_tokens(video), microbatches) \
            if stage.first else None
        saved = pipeline_forward(stage, parts,
                                 microbatch_shapes(shape, microbatches),
                                 video.dtype)
    finally:
        model.train(training)
    if not stage.last:
        return None
    x = merge_rows([None if s is None else s[1] for s in saved])
    return model.finish(x, video.shape[0])
