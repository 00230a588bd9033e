"""Sealed serving artifacts of the port: one ``torch.export`` program per
bucket beside ``params.npz`` and ``manifest.json``.

Port of ``videotransformer_tpu/serving/export.py::export_predictor``. The
artifact is a directory:

    manifest.json     num_frames, num_class, img_size, n_crops, buckets,
                      platforms, input_mode, input_shape, input_dtype
    predict_b{B}.pt2  the predict function of bucket B, traced once
    params.npz        {"model/a/b/c": array, "head/cls_head/kernel": ...}
                      in the JAX package's flat layouts (flatten_params)

Each program is ``torch.export.export`` of ``predictor.make_predict_fn``
(``make_raw_predict_fn`` for ``input_mode="raw"``) under ``no_grad``, with
the backbone in the working type (bf16 by default) and the head in fp32,
as ``TorchPredictor`` casts them. Its inputs are (model parameters, head
parameters, batch), the parameters as two dicts by the port's names in
sorted order: the weights are read from ``params.npz`` once at load and
the program holds none of them. It is traced on a meta-device copy of the
model, so no parameter is lifted into the program; only constants the
forward makes itself (the position table's resize weights at another
size) are. The kernels are in it as the ``vt::`` ops (``kernels/_ops.py``),
which dispatch by device when the program runs: the same program runs the
hand-written kernels on the card and their plain versions on the CPU. So
the manifest's ``platforms`` is ``["cpu", "cuda"]``; its other keys are the
JAX package's, with its values for the same arguments. A model built of
the fused blocks whose trace holds no ``vt::`` op is refused: that program
would run the plain versions on the card.

``serving.predictor.load_predictor`` serves the programs with no model code
(``programs=False``, or an artifact without ``.pt2`` files such as the JAX
package's, rebuilds the model from the parameter names instead). A
``.pt2`` file is tied to the torch version that wrote it: export where the
artifact is served.
"""

import copy
import json
import os

import numpy as np
import torch
from torch import nn

from videotransformer_tpu_torch.kernels import _ops
from videotransformer_tpu_torch.models.convert import state_dict_to_jax_flat
from videotransformer_tpu_torch.models.mvit import MultiScaleBlock
from videotransformer_tpu_torch.ops.blocks import FFN, _PrenormMHSA
from videotransformer_tpu_torch.serving.predictor import (
    make_predict_fn, make_raw_predict_fn, program_file, program_params)

PLATFORMS = ["cpu", "cuda"]
# the modules whose forward calls the kernels
_FUSED = (_PrenormMHSA, FFN, MultiScaleBlock)


def _on_meta(module):
    """A copy of ``module`` whose parameters and buffers are on the meta
    device (no data is copied)."""
    memo = {id(t): nn.Parameter(torch.empty_like(t, device="meta"),
                                requires_grad=False)
            if isinstance(t, nn.Parameter)
            else torch.empty_like(t, device="meta")
            for t in [*module.parameters(), *module.buffers()]}
    return copy.deepcopy(module, memo)


class _Served(nn.Module):
    """The model and head under the names the program's inputs carry
    (``model.*``, ``head.*``), running ``predict``."""

    def __init__(self, model, head, predict):
        super().__init__()
        self.model, self.head = model, head
        self._predict = predict

    def forward(self, x):
        return self._predict(x)


class _Program(nn.Module):
    """(model params, head params, x) -> logits: ``_Served`` with the
    parameters given, held outside the module tree so that the trace lifts
    none of its own."""

    def __init__(self, served):
        super().__init__()
        object.__setattr__(self, "_served", served)

    def forward(self, params, head_params, x):
        state = {f"model.{k}": v for k, v in params.items()}
        state.update({f"head.{k}": v for k, v in head_params.items()})
        return torch.func.functional_call(self._served, state, (x,))


def vt_op_counts(program):
    """{op name: nodes} of the ``vt::`` ops in an exported program's
    graph."""
    counts = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and _ops.is_op(node.target):
            name = node.target._schema.name.split("::")[1]
            counts[name] = counts.get(name, 0) + 1
    return counts


def export_program(model, head, input_shape, input_dtype, *, num_class,
                   n_crops, input_mode="clips", img_size=224,
                   dtype=torch.bfloat16):
    """The ``torch.export`` program of one bucket: a batch of
    ``input_shape`` (the bucket first) of ``input_dtype`` -> (B, num_class)
    fp32 crop-mean logits. Raises when the model runs the kernels and the
    graph holds no ``vt::`` op."""
    meta = _on_meta(model).to(dtype).eval()
    meta_head = _on_meta(head).float().eval()
    if input_mode == "raw":
        predict = make_raw_predict_fn(meta, meta_head, num_class, n_crops,
                                      img_size)
    else:
        predict = make_predict_fn(meta, meta_head, num_class, n_crops)
    params, head_params = program_params(model.state_dict(),
                                         head.state_dict(), dtype)
    x = torch.zeros(input_shape, dtype=input_dtype)
    with torch.no_grad():
        program = torch.export.export(
            _Program(_Served(meta, meta_head, predict)),
            (params, head_params, x), strict=False)
    program.example_inputs = None  # they hold the weights; save no copy
    fused = sum(isinstance(m, _FUSED) for m in model.modules())
    if fused and not vt_op_counts(program):
        raise RuntimeError(
            f"the program of a model with {fused} fused blocks holds no vt:: "
            f"op: it would run the plain versions on the card")
    return program


def export_predictor(path, model, head, *, num_frames, num_class,
                     img_size=224, n_crops=3, buckets=(1, 2, 4, 8),
                     input_mode="clips", raw_hw=(256, 342),
                     dtype=torch.bfloat16):
    """Write the artifact of a TimeSformer or ViViT ``model`` and its
    ``ClassificationHead`` to the directory ``path``. ``input_mode``
    "clips": requests carry float32 (n_crops, T, C, S, S) crop stacks (the
    program takes them in ``dtype``, as ``TorchPredictor`` passes them);
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
    buckets = sorted({int(b) for b in buckets})
    os.makedirs(path, exist_ok=True)
    flat = {f"model/{k}": v
            for k, v in state_dict_to_jax_flat(model.state_dict()).items()}
    flat.update({f"head/{k}": v
                 for k, v in state_dict_to_jax_flat(head.state_dict()).items()})
    np.savez(os.path.join(path, "params.npz"), **flat)
    traced = torch.uint8 if input_mode == "raw" else dtype
    for b in buckets:
        torch.export.save(
            export_program(model, head, [b, *input_shape], traced,
                           num_class=num_class, n_crops=n_crops,
                           input_mode=input_mode, img_size=img_size,
                           dtype=dtype),
            program_file(path, b))
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({
            "num_frames": num_frames, "num_class": num_class,
            "img_size": img_size, "n_crops": n_crops, "buckets": buckets,
            "platforms": PLATFORMS,
            "input_mode": input_mode, "input_shape": input_shape,
            "input_dtype": input_dtype.name,
        }, f, indent=1)
