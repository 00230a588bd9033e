"""Host-side clip loading and the eval transform (decode, resize, crop,
normalise), in PyTorch and OpenCV."""
