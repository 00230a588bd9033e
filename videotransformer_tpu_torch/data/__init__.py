"""The data path: decode (the native FFmpeg decoder, else OpenCV), host
transforms, the Kinetics dataset, the loader and the pinned-memory
prefetch on the host; the train augment and the eval recipe of uint8
clips, and MaskFeat's HOG targets, on the device; cube masks and mixup."""
