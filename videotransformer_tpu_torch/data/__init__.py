"""Host-side clip loading and the eval transform (decode, resize, crop,
normalise), in PyTorch and OpenCV; MaskFeat's HOG targets (on the device)
and cube masks (on the host)."""
