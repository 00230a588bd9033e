"""One adapter a model: ``vtbench/models/<model>.py``, found by the
configuration's ``"model"`` key (``registry.model``). The drivers and the
metric readers ask it for everything that depends on the model, so a new
model enters the benchmark as files. An adapter exposes:

- ``reference``: its plain module under ``vtbench/reference/`` (nothing of
  the port, nothing of JAX), with ``param_specs(cfg)``,
  ``train_draws(g, cfg, batch, device)``, ``train_loss(params, batch,
  draws, lo, hi, cfg, ops)`` and, for a served model, ``logits(params,
  video, cfg, ops)``;
- ``fwd_flops(cfg, clips)``: model FLOPs of one forward over ``clips``
  views;
- ``kernel_calls(cfg, clips, backward)``: the (flops, bytes) of every
  hand-written kernel call of one forward (and with ``backward`` its
  backward) over ``clips`` views, from ``counts.py``'s kernels; each
  raises ValueError for a configuration it does not count;
- for a served model, ``serving_model(cfg)``: the port's (model, head),
  which the serve driver exports.
"""
