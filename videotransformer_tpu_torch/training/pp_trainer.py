"""The pipeline-parallel trainer: GPipe over the pipe ranks of a mesh, in
the supervised training loop (``-pp N`` on the CLI).

Port of ``videotransformer_tpu/training/pp_trainer.py::PipelineTrainer``
(pp_trainer.py:48-111). Each process is one pipe rank: it holds one stage
of the model (``training/stacked_trainer.py``: L/P blocks, the embedding
on stage 0, the final norm and the head on the last stage) and the
optimizer moments of that stage alone. A step (``parallel/pp.py``):

- every pipe rank of a data rank gets the same batch (a broadcast over
  the pipe group, ``_model_group_batch``) and runs the augment and mixup
  on it, and makes every layer's DropPath draws, so that the step's
  generator draws what one process draws; stage 0 embeds the clips
  (``prepare_tokens``), the blocks run as a GPipe schedule of
  ``-pp_microbatch`` microbatches (0: one a stage, pp_trainer.py:57-58),
  and the last stage runs the final norm, the head and the loss on the
  microbatches' outputs put together (the space-only frame mean needs a
  clip's frames, which the row split spreads over microbatches): its share
  of the global mean, as under data parallelism. Its backward seeds each
  microbatch's backward through the stages, in reverse order, and stage 0
  ends with the embedding's;
- the loss and top-k counts go from the last stage to its pipe group (a
  broadcast), then each stage sums its gradients with the step's stats
  over its data group (``_reduce_step``); the clip stays per parameter and
  the logged norm is summed over the pipe group (``training/
  optimizer.py``);
- eval (one or three crops, the padded rounds of ``even_eval_batches``)
  runs the pipeline without grad and broadcasts the last stage's counts to
  its pipe group; every pipe rank of a data rank runs the same rounds;
- ``-remat`` checkpoints each of a stage's blocks as the one-process run
  does (``ops/blocks.py::checkpointed``), which changes no number.

Scope, as in JAX: supervised TimeSformer and ViViT with one block stack
(``stacked_trainer.check_scope``), data parallelism beside the pipeline and
nothing else: ``-tp`` and ``-sp`` with ``-pp`` are refused
(pp_trainer.py:60-62), and so are a layer count that ``-pp`` does not
divide (pp_trainer.py:70-71) and batch rows that do not divide by the
microbatches and the data ranks (pp_trainer.py:89-93). Every random
number is the one process's (``parallel/pp.py``), so a pipelined step is
held against the one-process step on the global batch.
"""

import torch
import torch.distributed as dist

from videotransformer_tpu_torch.parallel import pp
from videotransformer_tpu_torch.training.metrics import topk_correct
from videotransformer_tpu_torch.training.stacked_trainer import (
    StackedBlocksTrainer, check_scope)
from videotransformer_tpu_torch.training.trainer import (
    _as_tensor, cross_entropy, soft_target_cross_entropy)


def check_flags(configs, num_layers=None):
    """Refuse a pipelined run the JAX package refuses (pp_trainer.py:
    55-71), in its order: ``-pp`` with ``-tp`` or ``-sp``, then the scope,
    then ``num_layers`` (when given) that ``-pp`` does not divide."""
    pp_size = int(getattr(configs, "pp", 1))
    if pp_size <= 1:
        raise ValueError("PipelineTrainer needs -pp > 1")
    if getattr(configs, "sp", 1) != 1 or getattr(configs, "tp", 1) != 1:
        raise ValueError("pp composes with data parallelism only: -sp and "
                         "-tp are refused beside -pp, as in the JAX package")
    check_scope(configs)
    if num_layers is not None and num_layers % pp_size:
        raise ValueError(f"pipeline parallelism needs the layer count "
                         f"divisible by -pp: {num_layers} layers over "
                         f"{pp_size} stages")


def microbatch_count(configs):
    """``-pp_microbatch``, 0 meaning one a stage (pp_trainer.py:57-58)."""
    return int(getattr(configs, "pp_microbatch", 0) or 0) or int(configs.pp)


def check_rows(rows, microbatches, data):
    """Refuse ``rows`` token rows of the global batch that do not split
    into ``microbatches`` over ``data`` data ranks (pp_trainer.py:89-93)."""
    if rows % microbatches or (rows // microbatches) % data:
        raise ValueError(
            f"pipeline microbatching needs batch rows ({rows}) divisible by "
            f"microbatches ({microbatches}) x data axis ({data}); adjust "
            f"-batch_size or -pp_microbatch")


class PipelineTrainer(StackedBlocksTrainer):
    """A ``VideoTransformerTrainer`` with the blocks pipelined over
    ``mesh``'s pipe ranks (module doc); ``mesh.pipe`` is ``configs.pp``."""

    def __init__(self, configs, device, ckpt_dir=None, do_eval=False,
                 do_test=False, n_crops=3, seed=None, log_dir=None,
                 params=None, mesh=None):
        check_flags(configs)
        if mesh is None or mesh.pipe != configs.pp:
            raise ValueError(f"-pp {configs.pp} needs a mesh of as many pipe "
                             f"ranks, got {mesh}")
        self.microbatches = microbatch_count(configs)
        super().__init__(configs, device, ckpt_dir=ckpt_dir, do_eval=do_eval,
                         do_test=do_test, n_crops=n_crops, seed=seed,
                         log_dir=log_dir, params=params, mesh=mesh)

    def _microbatch_draws(self, shape):
        """Each microbatch's DropPath draws ({layer: RowDraws}) for token
        rows ``shape[0]`` of ``shape[1]`` tokens on this data rank."""
        mesh, rows, M = self.mesh, shape[0], self.microbatches
        total = rows * mesh.data
        draws = self.stage.drop_path_draws(self.generator, total, shape[1],
                                           self.dtype, self.device)
        start = mesh.data_rank * rows
        return [{i: pp.RowDraws(d, torch.arange(
                    start + m, start + rows, M, device=self.device), total)
                 for i, d in draws.items()} for m in range(M)]

    def _supervised_step(self, batch, lr, wd):
        video, labels, soft = self._train_inputs(batch)
        self.optimizer.zero_grad()
        stage, mesh, M = self.stage, self.mesh, self.microbatches
        shape = stage.tokens_shape(video.shape)
        check_rows(shape[0] * mesh.data, M, mesh.data)
        draws = None
        if self.linear_prob:
            self.model.eval()
        else:
            self.model.train()
            draws = self._microbatch_draws(shape)
        with torch.set_grad_enabled(not self.linear_prob):
            tokens = self.model.prepare_tokens(video) if stage.first \
                else None
            saved = pp.pipeline_forward(
                stage, None if tokens is None else pp.split_rows(tokens, M),
                pp.microbatch_shapes(shape, M), self.dtype, draws)
        stats = torch.zeros(3, device=self.device)
        d_outs = None
        if stage.last:
            outs = [y.detach().requires_grad_(not self.linear_prob)
                    for _, y in saved]
            logits = self.cls_head(self.model.finish(pp.merge_rows(outs),
                                                     video.shape[0]))
            if soft is not None:
                loss = soft_target_cross_entropy(logits, soft)
                labels = soft.argmax(-1)
            else:
                loss = cross_entropy(logits, labels)
            loss = loss / mesh.data  # this rank's share of the global mean
            loss.backward()
            d_outs = [o.grad for o in outs]
            correct = topk_correct(logits.detach(), labels)
            stats = torch.stack([loss.detach().float(), correct[1].float(),
                                 correct[5].float()])
        if not self.linear_prob:
            grads = pp.pipeline_backward(stage, saved, d_outs)
            if stage.first:
                tokens.backward(pp.merge_rows(grads))
        dist.broadcast(stats, src=mesh.pipe_ranks[-1], group=mesh.pipe_group)
        loss, (top1, top5) = self._reduce_step(stats[0], stats[1:].unbind())
        grad_norm = self._update(lr, wd)
        return {"loss": loss, "grad_norm": grad_norm, "top1": top1,
                "top5": top5, "bs": video.shape[0] * mesh.data}

    def _eval_step(self, batch, n_crops):
        video = self._eval_video(batch, n_crops)
        labels = _as_tensor(batch["label"], self.device)
        feats = pp.pipelined_forward_features(self.stage, video,
                                              self.microbatches)
        stats = torch.zeros(3, dtype=torch.int64, device=self.device)
        if self.stage.last:
            stats = torch.stack(self._eval_counts(
                self.cls_head(feats), labels, n_crops)).to(torch.int64)
        dist.broadcast(stats, src=self.mesh.pipe_ranks[-1],
                       group=self.mesh.pipe_group)
        top1, top5, bs = stats.unbind()
        return {"top1": top1, "top5": top5, "bs": bs}
