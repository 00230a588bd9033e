"""Batched, bucketed predictor over a serving artifact.

Port of ``videotransformer_tpu/serving/export.py``: ``make_predict_fn``'s
crop mean (per-crop logits averaged over the ThreeCrop stack, the notebook's
``output.view(-1, 3, 400).mean(1)``), and a ``TorchPredictor`` with
``ExportedPredictor``'s interface: ``buckets``, ``max_batch``, padding on
the host to the next bucket, ``warmup``, ``n_crops``, ``manifest``.

``load_predictor`` reads an artifact directory. Where it holds the port's
``predict_b{B}.pt2`` programs (``serving/export.py``), it serves them, as
the JAX package's ``ExportedPredictor`` serves its ``.shlo`` programs: no
model class is built and no head count is needed; each program is loaded
with ``torch.export.load``, moved to the device
(``torch.export.passes.move_to_device_pass``), and called with the
``params.npz`` weights, put on the device once in the program's working
type (the head's in fp32). The ``vt::`` ops in the programs dispatch by
device: the kernels on the card, their plain versions on the CPU.

An artifact without programs (the JAX package's, whose ``.shlo`` programs
need jax) is served by the model rebuilt from the parameter names
(``model_type``): any of TimeSformer's three attention types and ViViT's
three, its head count an argument (``embed_dims // 64`` by default). The
model is built at the size its position table was trained at, so a
manifest ``img_size`` above it resizes the table on every forward, as the
JAX artifact's program does. The manifest's ``input_mode`` says what a
request carries: "clips", preprocessed float32 (n_crops, T, C, S, S) crop
stacks, or "raw", the decoder's canonical uint8 (T, raw_h, raw_w, 3) clip
(``input_shape`` and ``input_dtype``, export.py:150-153), which goes to the
device as uint8 and through the eval recipe there (``make_raw_predict_fn``;
export.py:66-90). Both ways are one ``TorchPredictor``; only its callable
differs.
"""

import json
import os

import numpy as np
import torch
import torch.export.passes

from videotransformer_tpu_torch.data.device_augment import (
    eval_preprocess_batch)
from videotransformer_tpu_torch.models.convert import split_artifact_params
from videotransformer_tpu_torch.models.timesformer import TimeSformer
from videotransformer_tpu_torch.models.vivit import ViViT
from videotransformer_tpu_torch.ops.blocks import ClassificationHead


def make_predict_fn(model, head, num_class, n_crops):
    """clips (B, n_crops, T, C, H, W) -> (B, num_class) crop-averaged fp32
    logits. The backbone runs in the model's working type; the head runs in
    fp32 on the features, as the JAX package's fp32 head does."""

    def predict(clips):
        b, nc, t, c, h, w = clips.shape
        feats = model(clips.reshape(b * nc, t, c, h, w))
        logits = head(feats.float())
        return logits.reshape(b, nc, num_class).mean(dim=1)

    return predict


def make_raw_predict_fn(model, head, num_class, n_crops, img_size,
                        mean=(0.45,) * 3, std=(0.225,) * 3):
    """raw (B, T, H, W, 3) uint8 -> (B, num_class) crop-averaged fp32
    logits: the eval recipe on the device (``eval_preprocess_batch``:
    ThreeCrop for 3 crops, else CenterCrop), then ``make_predict_fn``'s
    forward."""
    forward = make_predict_fn(model, head, num_class, n_crops)
    dtype = next(model.parameters()).dtype

    def predict(raw):
        clips = eval_preprocess_batch(raw, img_size=img_size,
                                      three_crop=n_crops == 3, mean=mean,
                                      std=std)  # (B·n_crops, T, C, S, S)
        return forward(clips.unflatten(0, (raw.shape[0], n_crops)).to(dtype))

    return predict


def program_file(path, bucket):
    """The program of ``bucket`` in an artifact directory."""
    return os.path.join(path, f"predict_b{bucket}.pt2")


class TorchPredictor:
    """Callable over numpy requests of the manifest's ``input_shape`` and
    ``input_dtype`` -> (B, num_class) numpy logits. Pads the batch on the
    host to the next bucket, runs it on ``device``, unpads; batches above
    the largest bucket run in chunks. Built from a model and head (the
    model's forward, ``make_predict_fn``) or by ``from_programs`` (one
    exported program a bucket); ``model`` and ``head`` are None for the
    latter."""

    def __init__(self, model, head, manifest, device, dtype=torch.bfloat16):
        self._configure(manifest, device, dtype)
        # weights cast once here to the working type; the head stays fp32
        self.model = model.to(device=self.device, dtype=dtype).eval()
        self.head = head.to(device=self.device, dtype=torch.float32).eval()
        if self.input_mode == "raw":
            self._predict = make_raw_predict_fn(
                self.model, self.head, self.num_class, self.n_crops,
                manifest["img_size"])
        else:
            self._predict = make_predict_fn(self.model, self.head,
                                            self.num_class, self.n_crops)

    @classmethod
    def from_programs(cls, programs, params, head_params, manifest, device,
                      dtype):
        """Over ``programs`` ({bucket: module whose ``forward(params,
        head_params, x)`` gives the logits, ``program_module``'s}) and their
        parameter inputs, already on ``device``
        (``program_params``); ``dtype`` is the programs'
        working type."""
        self = cls.__new__(cls)
        self._configure(manifest, device, dtype)
        self.model = self.head = None
        self.programs = programs
        self.params, self.head_params = params, head_params
        # the graph's forward without the per-call shape checks of
        # ``ExportedProgram.module()``'s pre-hook, host time on every call:
        # the inputs are the loader's parameters and a batch padded to the
        # bucket
        self._predict = lambda x: programs[x.shape[0]].forward(
            self.params, self.head_params, x)
        return self

    def _configure(self, manifest, device, dtype):
        self.manifest = manifest
        self.buckets = sorted(int(b) for b in manifest["buckets"])
        self.num_class = manifest["num_class"]
        self.n_crops = manifest["n_crops"]
        self.input_mode = manifest.get("input_mode", "clips")
        self.device = torch.device(device)
        self.dtype = dtype
        if self.input_mode == "raw":
            self.input_dtype = np.dtype(manifest.get("input_dtype", "uint8"))
            self.input_shape = tuple(manifest["input_shape"])
        elif self.input_mode == "clips":
            self.input_dtype = np.dtype(np.float32)
            self.input_shape = (self.n_crops, manifest["num_frames"], 3,
                                manifest["img_size"], manifest["img_size"])
        else:
            raise ValueError(f"input_mode {self.input_mode!r}: want 'clips' "
                             "or 'raw'")

    @property
    def max_batch(self):
        return self.buckets[-1]

    def _bucket(self, n):
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    @torch.inference_mode()
    def __call__(self, clips):
        clips = np.asarray(clips, self.input_dtype)
        n = clips.shape[0]
        out = []
        i = 0
        while i < n:
            take = min(n - i, self.max_batch)
            b = self._bucket(take)
            chunk = clips[i:i + take]
            if take < b:
                chunk = np.concatenate(
                    [chunk, np.zeros((b - take,) + chunk.shape[1:],
                                     chunk.dtype)], axis=0)
            x = torch.from_numpy(chunk).to(self.device)
            if self.input_mode == "clips":
                x = x.to(self.dtype)
            logits = self._predict(x)
            out.append(logits[:take].float().cpu().numpy())
            i += take
        return np.concatenate(out, axis=0)

    def warmup(self):
        """Run every bucket once, through ``__call__`` (builds the kernels
        and warms the allocator before the first request)."""
        for b in self.buckets:
            self(np.zeros((b,) + self.input_shape, self.input_dtype))


def model_type(keys, patch_rank):
    """(arch, attention_type) from an artifact's parameter names (the JAX
    package's flat ``model/...`` keys) and its patch kernel's rank:
    ``spatial_transformer`` is a ViViT fact_encoder; a 5-D (Conv3d) patch
    kernel is ViViT, divided with ``attentions_1``, else joint; a 4-D one
    is TimeSformer, divided with ``attentions_1``, space_only without
    ``time_embed``, else joint."""
    divided = any("/attentions_1/" in k for k in keys)
    if any(k.startswith("model/spatial_transformer/") for k in keys):
        return "vivit", "fact_encoder"
    if patch_rank == 5:
        return "vivit", ("divided_space_time" if divided
                         else "joint_space_time")
    if divided:
        return "timesformer", "divided_space_time"
    if "model/time_embed" not in keys:
        return "timesformer", "space_only"
    return "timesformer", "joint_space_time"


def _depth(state_dict, stack):
    return len({k[len(stack):].split(".")[0] for k in state_dict
                if k.startswith(stack)})


def model_from_state_dict(state_dict, arch, attention_type, num_frames,
                          num_heads):
    """The TimeSformer or ViViT shaped by a converted state dict, its
    weights loaded strictly. The width, patch size, tube, depths and the
    native image size (from the position table) come from the weights; the
    head count is not recorded in them, so it is an argument."""
    patch = state_dict["patch_embed.projection.weight"]
    embed_dims, patch_size = patch.shape[0], patch.shape[-1]
    side = int(round((state_dict["pos_embed"].shape[1] - 1) ** 0.5))
    geometry = dict(num_frames=num_frames, img_size=side * patch_size,
                    patch_size=patch_size, embed_dims=embed_dims,
                    num_heads=num_heads, attention_type=attention_type)
    if arch == "vivit":
        if attention_type == "fact_encoder":
            geometry.update(
                num_transformer_layers=_depth(
                    state_dict, "transformer_layers.0.layers."),
                num_time_transformer_layers=_depth(
                    state_dict, "transformer_layers.1.layers."))
        else:
            geometry["num_transformer_layers"] = _depth(
                state_dict, "transformer_layers.layers.")
        model = ViViT(tube_size=patch.shape[2], **geometry)
    else:
        model = TimeSformer(num_transformer_layers=_depth(
            state_dict, "transformer_layers.layers."), **geometry)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()}, strict=True)
    return model


def program_params(model_sd, head_sd, dtype, device="cpu"):
    """The program's parameter inputs from two state dicts (tensors or
    numpy arrays): the model's in ``dtype``, the head's in fp32, on
    ``device``, each dict in sorted name order."""
    def put(sd, dt):
        return {k: torch.as_tensor(sd[k]).to(device=device, dtype=dt)
                for k in sorted(sd)}
    return put(model_sd, dtype), put(head_sd, torch.float32)


def load_program(path, device):
    """An exported program moved to ``device``, and its working type (the
    dtype of its first input, a model parameter)."""
    program = torch.export.load(path)
    if torch.device(device).type != "cpu":
        program = torch.export.passes.move_to_device_pass(program, device)
    first = program.graph_signature.user_inputs[0]
    node = next(n for n in program.graph.nodes if n.name == first)
    return program, node.meta["val"].dtype


def program_module(program):
    """``program.module()`` without the no-op casts of the trace: each
    ``.to(dtype)`` of a tensor already of that dtype (the blocks cast every
    weight to the working type at each use) and the
    ``_assert_tensor_metadata`` export puts before it.
    Eager PyTorch returns the tensor itself for such a cast, so the bits do
    not change; the graph sheds two Python op calls a cast."""
    module = program.module()
    graph = module.graph
    to, check = torch.ops.aten.to.dtype, \
        torch.ops.aten._assert_tensor_metadata.default
    for node in list(graph.nodes):
        if node.op != "call_function":
            continue
        if node.target is check:
            graph.erase_node(node)
        elif (node.target is to and len(node.args) == 2 and not node.kwargs
              and "val" in node.args[0].meta
              and node.args[0].meta["val"].dtype == node.args[1]):
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
    module.recompile()
    return module


def load_predictor(path, device, num_heads=None, dtype=None, programs=True):
    """TorchPredictor over an artifact directory (the JAX package's or the
    port's) of any TimeSformer or ViViT type: its ``predict_b{B}.pt2``
    programs where it has them and ``programs`` is on, in their working
    type (``dtype``, when given, must be it); else the model rebuilt from
    the parameter names in ``dtype`` (bf16 by default), ``num_heads``
    defaulting to embed_dims // 64 (the ViT-B head width)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "params.npz")) as flat:
        flat = {k: flat[k] for k in flat.files}
    model_sd, head_sd = split_artifact_params(flat)
    files = {b: program_file(path, b) for b in manifest["buckets"]}
    present = [os.path.exists(f) for f in files.values()]
    if programs and any(present):
        if not all(present):
            raise FileNotFoundError(
                f"{path}: programs of buckets {manifest['buckets']} "
                f"incomplete: {[f for f, p in zip(files.values(), present) if not p]}")
        loaded = {b: load_program(f, device) for b, f in files.items()}
        working = {dt for _, dt in loaded.values()}
        if len(working) != 1 or (dtype is not None and dtype not in working):
            raise ValueError(f"{path}: programs traced in {working}, asked "
                             f"for {dtype}")
        (dtype,) = working
        params, head_params = program_params(model_sd, head_sd, dtype, device)
        return TorchPredictor.from_programs(
            {b: program_module(p) for b, (p, _) in loaded.items()}, params,
            head_params, manifest, device, dtype)
    arch, attention_type = model_type(
        flat, flat["model/patch_embed/projection/kernel"].ndim)
    embed_dims = model_sd["cls_token"].shape[-1]
    model = model_from_state_dict(model_sd, arch, attention_type,
                                  manifest["num_frames"],
                                  num_heads or embed_dims // 64)
    num_class, in_ch = head_sd["cls_head.weight"].shape
    head = ClassificationHead(num_class, in_ch)
    head.load_state_dict({k: torch.from_numpy(v) for k, v in head_sd.items()},
                         strict=True)
    return TorchPredictor(model, head, manifest, device,
                          dtype or torch.bfloat16)
