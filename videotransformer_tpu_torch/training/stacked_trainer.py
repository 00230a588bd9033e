"""The layout that a trainer of blocks split by depth shares: what each
pipe rank holds, and the canonical checkpoints it reads and writes.

Port of ``StackedBlocksTrainer``'s shared part
(``videotransformer_tpu/training/stacked_trainer.py:47-175``). JAX stacks
the L per-layer subtrees on a leading axis for ``lax.scan`` and the
pipeline; here a stage holds its blocks under their global names
(``parallel/pp.py::Stage``), so nothing is stacked or unstacked:

- ``check_scope``: supervised TimeSformer or ViViT with one homogeneous
  block stack (stacked_trainer.py:52-60): MaskFeat, ``arch=mvit`` and
  ViViT's ``fact_encoder`` are refused;
- ``_place``: the model, built and initialised whole (the seed's draws, a
  JAX tree, an imported checkpoint), is cut to this pipe rank's stage
  before it goes to the device: its blocks, the embedding on stage 0, the
  final norm and the head on the last stage. Its optimizer then holds the
  moments of those parameters only. Each stage's parameters are its data
  rank 0's (a broadcast over the data group);
- the per-layer block keeps its DropPath rate, the reference's linspace
  (transformer.py:543), which the port's ``TransformerContainer`` holds
  already (``Stage.rates``);
- checkpoints are canonical: ``model_state_dict``, ``head_state_dict``
  and the moments are gathered over the pipe group in the one-process
  format, which rank 0 writes (``save_checkpoint``); ``load_checkpoint``,
  ``load_params`` and ``import_pretrained`` take the stage's slice of a
  whole state. A pipelined run's checkpoint loads into a one-process
  trainer and back.

``ScanLayersTrainer`` and ``-scan_layers`` are not ported (ROADMAP "Do not
port"): ``PipelineTrainer`` (``training/pp_trainer.py``) is the one
subclass.
"""

from videotransformer_tpu_torch.parallel import mesh as _mesh
from videotransformer_tpu_torch.parallel import pp
from videotransformer_tpu_torch.training.trainer import VideoTransformerTrainer


def check_scope(configs):
    """Refuse what a split block stack cannot run (JAX
    stacked_trainer.py:52-60): supervised TimeSformer or ViViT, not
    ViViT's two-stack fact_encoder."""
    if configs.objective != "supervised":
        raise ValueError("stacked-block training: supervised only "
                         "(MaskFeat/MViT has a heterogeneous, "
                         "resolution-changing stack)")
    arch = getattr(configs, "arch", "timesformer")
    if arch not in ("timesformer", "vivit"):
        raise ValueError(f"stacked-block training: arch timesformer or "
                         f"vivit, not {arch}")
    if getattr(configs, "attention_type",
               "divided_space_time") == "fact_encoder":
        raise ValueError("fact_encoder has two heterogeneous transformer "
                         "stacks")


class StackedBlocksTrainer(VideoTransformerTrainer):
    """A ``VideoTransformerTrainer`` whose ``self.model`` is this pipe
    rank's stage (``self.stage``) of the model (module doc); ``mesh`` has
    a pipe axis."""

    stage = None  # the whole model until _place cuts it to the stage

    def _place(self):
        mesh = self.mesh
        last = mesh.pipe - 1
        head = self.cls_head
        head_layout = [] if head is None else [
            (k, v.shape, v.dtype, last) for k, v in head.state_dict().items()]
        self.stage = pp.Stage(self.model, mesh)
        self._head_layout = head_layout
        # the optimizer's names, in its order (the trainer's __init__)
        self._opt_layout = [] if self.linear_prob else [
            (f"model.{n}", shape, dt, q)
            for n, shape, dt, q in self.stage.layout]
        self._opt_layout += [(f"cls_head.{n}", shape, dt, q)
                             for n, shape, dt, q in head_layout]
        if not self.stage.last:
            self.cls_head = None
        self.model.to(self.device)
        parts = [self.model] + ([] if self.cls_head is None
                                else [self.cls_head.to(self.device)])
        if mesh.data > 1:  # the stage's parameters of its data rank 0
            for part in parts:
                _mesh.broadcast_([t.data for t in part.state_dict().values()],
                                 src=mesh.data_ranks[0],
                                 group=mesh.data_group)

    def _set_model_state(self, state, strict=True):
        if self.stage is not None:
            state = self.stage.own(state)
        return self.model.load_state_dict(state, strict=strict)

    def import_pretrained(self, path):
        if self.stage is None:
            return super().import_pretrained(path)
        return self._import_into_whole(path)

    def model_state_dict(self):
        """The whole canonical model state, gathered over the pipe group
        (every pipe rank must call it)."""
        return pp.gather_stages(self.model.state_dict(), self.stage.layout,
                                self.mesh)

    def head_state_dict(self):
        """The head's state, the last stage's, on every pipe rank."""
        if not self._head_layout:
            return None
        local = {} if self.cls_head is None else self.cls_head.state_dict()
        return pp.gather_stages(local, self._head_layout, self.mesh)

    def _gather_moments(self, opt_state):
        for k in ("mu", "nu"):
            opt_state[k] = pp.gather_stages(opt_state[k], self._opt_layout,
                                            self.mesh)
        return opt_state

    def _local_moments(self, opt_state):
        # the optimizer reads its own parameters' entries of a whole state
        return opt_state
