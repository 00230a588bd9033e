"""Serving artifacts of the port: ``params.npz`` + ``manifest.json``.

Port of ``videotransformer_tpu/serving/export.py::export_predictor`` without
its StableHLO programs. The artifact is a directory:

    manifest.json   num_frames, num_class, img_size, n_crops, buckets,
                    platforms, input_mode, input_shape, input_dtype
    params.npz      {"model/a/b/c": array, "head/cls_head/kernel": ...}
                    in the JAX package's flat layouts (flatten_params)

The manifest holds the JAX package's keys with its values for the same
arguments, but for ``platforms``: there it lists the XLA platforms the
``predict_b{B}.shlo`` programs were lowered for, and the port writes no
program, so it writes ``[]``. The port's ``serving.predictor.load_predictor``
serves the artifact (the model's type is read from its parameter names);
the JAX package's ``load_predictor`` cannot, since it has no ``.shlo``.
"""

import json
import os

import numpy as np

from videotransformer_tpu_torch.models.convert import state_dict_to_jax_flat


def export_predictor(path, model, head, *, num_frames, num_class,
                     img_size=224, n_crops=3, buckets=(1, 2, 4, 8),
                     input_mode="clips", raw_hw=(256, 342)):
    """Write the artifact of a TimeSformer or ViViT ``model`` and its
    ``ClassificationHead`` to the directory ``path``. ``input_mode``
    "clips": requests carry float32 (n_crops, T, C, S, S) crop stacks;
    "raw": the decoder's canonical uint8 (T, raw_h, raw_w, 3) clip, with the
    eval recipe on the device (``predictor.make_raw_predict_fn``). The
    model need not be built at ``img_size``: its position table is then
    resized on every forward (``interpolate_pos_encoding``), as the JAX
    package's ``tools/export_serving.py`` does."""
    if input_mode == "raw":
        input_shape = [num_frames, raw_hw[0], raw_hw[1], 3]
        input_dtype = np.dtype(np.uint8)
    elif input_mode == "clips":
        input_shape = [n_crops, num_frames, 3, img_size, img_size]
        input_dtype = np.dtype(np.float32)
    else:
        raise ValueError(f"input_mode {input_mode!r}: want 'clips' or 'raw'")
    os.makedirs(path, exist_ok=True)
    flat = {f"model/{k}": v
            for k, v in state_dict_to_jax_flat(model.state_dict()).items()}
    flat.update({f"head/{k}": v
                 for k, v in state_dict_to_jax_flat(head.state_dict()).items()})
    np.savez(os.path.join(path, "params.npz"), **flat)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({
            "num_frames": num_frames, "num_class": num_class,
            "img_size": img_size, "n_crops": n_crops,
            "buckets": sorted({int(b) for b in buckets}), "platforms": [],
            "input_mode": input_mode, "input_shape": input_shape,
            "input_dtype": input_dtype.name,
        }, f, indent=1)
