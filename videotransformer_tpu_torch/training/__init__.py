"""Training of the port: the trainer (``trainer``: supervised TimeSformer
and MViT, MaskFeat pretraining), its optimizer, schedules and metrics, and
the pipeline-parallel trainer (``pp_trainer`` on ``stacked_trainer``'s
layout)."""
