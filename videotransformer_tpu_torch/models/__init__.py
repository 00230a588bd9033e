"""Models of the port: TimeSformer (divided, joint and space-only
attention), ViViT (factorised encoder, joint and divided attention), MViT
and MaskFeat, and the converter from the JAX package's parameters."""

from videotransformer_tpu_torch.models.timesformer import TimeSformer
from videotransformer_tpu_torch.models.vivit import ViViT

__all__ = ["TimeSformer", "ViViT"]
