"""PyTorch/CUDA port of videotransformer_tpu (see README, "PyTorch/CUDA port")."""
