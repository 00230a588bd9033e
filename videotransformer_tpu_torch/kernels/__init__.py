"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``fused_mhsa`` (prenorm MHSA) and ``fused_ffn`` (prenorm FFN).
Sources are in ``videotransformer_tpu_torch/csrc``; ``_build`` compiles them
at first use."""
