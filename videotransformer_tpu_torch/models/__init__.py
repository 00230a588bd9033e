"""Models of the port: TimeSformer (divided space-time), MViT and MaskFeat,
and the converter from the JAX package's parameters."""
