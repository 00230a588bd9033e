"""Training of the port: the trainer (``trainer``: supervised TimeSformer
and MViT, MaskFeat pretraining), its optimizer, schedules and metrics."""
