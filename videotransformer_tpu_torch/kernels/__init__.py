"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``fused_mhsa`` (prenorm MHSA), ``fused_ffn`` (prenorm FFN) and
``flash_attention`` (q-blocked flash attention, Nq != Nkv).
Sources are in ``videotransformer_tpu_torch/csrc``; ``_build`` compiles them
at first use."""
