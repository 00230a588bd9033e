"""JAX package parameters (numpy) <-> the port's ``state_dict``.

The input is the flat ``{"a/b/c": ndarray}`` form of
``videotransformer_tpu/serving/export.py::flatten_params``, as stored in a
serving artifact's ``params.npz`` under the ``model/`` and ``head/``
prefixes, or the JAX trainer's nested parameter tree
``{"model": ..., "cls_head": {"cls_head": ...}}``
(``videotransformer_tpu/training/trainer.py:167-175``), which
``trainer_tree_to_state_dicts`` and ``state_dicts_to_trainer_tree`` convert
in both directions. The output names are those of
``videotransformer_tpu.models.convert.flax_to_torch_state_dict`` (the
original PyTorch repo's), which the port's modules use, so
``load_state_dict(strict=True)`` takes them. A ViViT fact_encoder's two
stacks, ``spatial_transformer`` and ``temporal_transformer`` in the JAX
package, are ``transformer_layers.0`` and ``.1`` there (convert.py:486-495
and :296-303). A MaskFeat/MViT tree (its
model has an ``mvit`` subtree) takes pytorchvideo's names on top, those of
``maskfeat_flax_to_torch_state_dict`` (``patch_embed.patch_model.*``,
``mlp.fc1``, ``attn.pool_q.weight``), so a MaskFeat checkpoint of the
original repo loads too. A MaskFeat pretraining tree has no ``cls_head``.

The second half is the checkpoint ecosystem of the JAX package's
``models/convert.py``: reading the original repo's ``.pth`` files, the
ViT, MAE and Kinetics surgery on their state dicts, the non-strict merge
into a module, and the reference ``.pth`` export. Its output names are the
port's module names, so there is no flax conversion step.

This is a port, not an import: importing ``videotransformer_tpu.models``
needs jax and flax, which the card's machine does not have.
"""

import argparse
import os
import re

import numpy as np
import torch

_INDEXED = re.compile(r"(layers|attentions|ffns|blocks)_(\d+)")
# a ViViT fact_encoder's stacks: flax name <-> torch name
_FACT_STACKS = {"spatial_transformer": "transformer_layers.0",
                "temporal_transformer": "transformer_layers.1"}
_FACT_NAME = re.compile(r"^transformer_layers\.([01])\.")


def _leaf(name, value):
    """flax leaf -> torch (name, array): Linear kernels (in, out) -> (out, in),
    Conv2d kernels (kh, kw, in, out) -> (out, in, kh, kw), Conv3d kernels
    (kt, kh, kw, in, out) -> (out, in, kt, kh, kw), LayerNorm scale ->
    weight."""
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        if value.ndim == 5:
            return "weight", value.transpose(4, 3, 0, 1, 2)
        raise ValueError(f"unhandled kernel rank {value.ndim}")
    if name == "scale":
        return "weight", value
    return name, value


def jax_flat_to_state_dict(flat):
    """{"a/b/c": array} (one module's params, no prefix) -> {"a.b.c": fp32
    array} with the original repo's names. Inside an FFN every linear but the
    last sits in a ``Sequential``: ``layers_i -> layers.i.0``; a ViViT
    fact_encoder's stacks are ``transformer_layers.0`` and ``.1``."""
    # number of linear layers of each FFN, keyed by the FFN's path prefix
    ffn_layers = {}
    for key in flat:
        parts = key.split("/")
        for i, part in enumerate(parts[:-1]):
            if (_INDEXED.fullmatch(part) and part.startswith("ffns_")
                    and re.fullmatch(r"layers_\d+", parts[i + 1])):
                ffn_layers.setdefault(tuple(parts[:i + 1]), set()).add(
                    parts[i + 1])
    out = {}
    for key, value in flat.items():
        parts = key.split("/")
        names = []
        for i, part in enumerate(parts[:-1]):
            m = _INDEXED.fullmatch(part)
            if not m:
                names.append(_FACT_STACKS.get(part, part) if i == 0 else part)
                continue
            kind, idx = m.group(1), int(m.group(2))
            names.append(f"{kind}.{idx}")
            n_ffn = len(ffn_layers.get(tuple(parts[:i]), ()))
            if kind == "layers" and idx < n_ffn - 1:
                names.append("0")
        leaf, arr = _leaf(parts[-1], np.asarray(value))
        out[".".join(names + [leaf])] = np.ascontiguousarray(
            arr, dtype=np.float32)
    return out


def split_artifact_params(npz_flat):
    """A serving artifact's flat params -> (model state_dict, head
    state_dict), from the ``model/`` and ``head/`` prefixes."""
    model = {k[len("model/"):]: v for k, v in npz_flat.items()
             if k.startswith("model/")}
    head = {k[len("head/"):]: v for k, v in npz_flat.items()
            if k.startswith("head/")}
    return jax_flat_to_state_dict(model), jax_flat_to_state_dict(head)


def _state_name_to_flax(name):
    """"a.layers.0.ffns.0.layers.0.0.weight" -> ("a/layers_0/ffns_0/layers_0",
    "weight"): the inverse of ``jax_flat_to_state_dict``'s naming."""
    fact = _FACT_NAME.match(name)
    if fact:
        stack = ("spatial_transformer", "temporal_transformer")[
            int(fact.group(1))]
        name = f"{stack}.{name[fact.end():]}"
    parts = name.split(".")
    out, i = [], 0
    while i < len(parts) - 1:
        part = parts[i]
        if (_INDEXED.fullmatch(f"{part}_0") and i + 1 < len(parts) - 1
                and parts[i + 1].isdigit()):
            out.append(f"{part}_{parts[i + 1]}")
            i += 2
            # an FFN's Sequential index: layers.i.0 -> layers_i
            if part == "layers" and "ffns_" in "/".join(out[:-1]) \
                    and i < len(parts) - 1 and parts[i].isdigit():
                i += 1
        else:
            out.append(part)
            i += 1
    return "/".join(out), parts[-1]


def _leaf_to_flax(leaf, value):
    """torch leaf -> flax (name, array), the inverse of ``_leaf``."""
    if leaf == "weight":
        if value.ndim == 1:
            return "scale", value
        if value.ndim == 2:
            return "kernel", value.T
        if value.ndim == 4:
            return "kernel", value.transpose(2, 3, 1, 0)
        if value.ndim == 5:
            return "kernel", value.transpose(2, 3, 4, 1, 0)
        raise ValueError(f"unhandled weight rank {value.ndim}")
    return leaf, value


def state_dict_to_jax_flat(state_dict):
    """{"a.b.c": array or tensor} -> {"a/b/c": fp32 array} in the JAX
    package's layouts: the inverse of ``jax_flat_to_state_dict``."""
    out = {}
    for name, value in state_dict.items():
        value = np.asarray(value.detach().cpu() if hasattr(value, "detach")
                           else value)
        prefix, leaf = _state_name_to_flax(name)
        leaf, arr = _leaf_to_flax(leaf, value)
        key = f"{prefix}/{leaf}" if prefix else leaf
        out[key] = np.ascontiguousarray(arr, dtype=np.float32)
    return out


def flatten_tree(tree, prefix=""):
    """Nested dict of arrays -> {"a/b/c": ndarray}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(flatten_tree(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_tree(flat):
    """{"a/b/c": array} -> nested dict: the inverse of ``flatten_tree``."""
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


# generic torch name -> pytorchvideo's, for MaskFeat/MViT (the JAX package's
# maskfeat_flax_to_torch_state_dict, convert.py:522-537)
_MASKFEAT_NAMES = (
    (re.compile(r"^patch_embed\."), "patch_embed.patch_model."),
    (re.compile(r"(^|\.)mlp_fc([12])\."), r"\1mlp.fc\2."),
    (re.compile(r"(^|\.)pool_([qkv])\.conv\.weight$"), r"\1pool_\2.weight"),
)
_GENERIC_NAMES = (
    (re.compile(r"^patch_embed\.patch_model\."), "patch_embed."),
    (re.compile(r"(^|\.)mlp\.fc([12])\."), r"\1mlp_fc\2."),
    (re.compile(r"(^|\.)pool_([qkv])\.weight$"), r"\1pool_\2.conv.weight"),
)


def _rename(state_dict, rules):
    out = {}
    for name, value in state_dict.items():
        for pattern, repl in rules:
            name = pattern.sub(repl, name)
        out[name] = value
    return out


def maskfeat_flat_to_state_dict(flat):
    """A MaskFeat/MViT model's {"a/b/c": array} -> its state_dict, with the
    keys of ``maskfeat_flax_to_torch_state_dict``."""
    return _rename(jax_flat_to_state_dict(flat), _MASKFEAT_NAMES)


def maskfeat_state_dict_to_flat(state_dict):
    """The inverse of ``maskfeat_flat_to_state_dict``."""
    return state_dict_to_jax_flat(_rename(state_dict, _GENERIC_NAMES))


def _is_maskfeat(model_tree):
    return "mvit" in model_tree


def trainer_tree_to_state_dicts(tree):
    """The JAX trainer's ``{"model": ..., "cls_head": {"cls_head": ...}}``
    (numpy leaves) -> (model state_dict, head state_dict or None when the
    tree has no head), fp32 arrays."""
    to_sd = (maskfeat_flat_to_state_dict if _is_maskfeat(tree["model"])
             else jax_flat_to_state_dict)
    head = tree.get("cls_head")
    return (to_sd(flatten_tree(tree["model"])),
            None if head is None
            else jax_flat_to_state_dict(flatten_tree(head)))


def state_dicts_to_trainer_tree(model_sd, head_sd=None):
    """(model state_dict, head state_dict or None) -> the JAX trainer's
    nested parameter tree, fp32 numpy leaves in flax layouts."""
    maskfeat = any(k.startswith("mvit.") for k in model_sd)
    to_flat = maskfeat_state_dict_to_flat if maskfeat else state_dict_to_jax_flat
    tree = {"model": unflatten_tree(to_flat(model_sd))}
    if head_sd is not None:
        tree["cls_head"] = unflatten_tree(state_dict_to_jax_flat(head_sd))
    return tree


# ---------------------------------------------------------------------------
# checkpoint import: the original repo's weight_init.py surgery, ported from
# the JAX package's convert.py:42-258, 362-451 (numpy arrays throughout)
# ---------------------------------------------------------------------------

def read_checkpoint(path):
    """``torch.load`` of a ``.pth``/``.pt`` file onto the CPU.

    Loaded with ``weights_only=True`` (tensors, containers and plain
    scalars), with ``argparse.Namespace`` allowed on top, which a Lightning
    checkpoint of the original repo holds under ``hyper_parameters``. The
    JAX package loads with ``weights_only=False``, which runs whatever the
    pickle names: a downloaded checkpoint is outside input, so the port
    unpickles nothing else, and a file that holds another object raises
    (torch names the refused global)."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        return torch.load(path, map_location="cpu", weights_only=True)


def load_torch_state_dict(checkpoint):
    """A checkpoint (a path, or what ``read_checkpoint`` returned for one)
    -> {key: np.ndarray}: the ``state_dict`` entry if there is one, then the
    ``model`` entry if every other entry is not a tensor (convert.py:42-53);
    entries that are not tensors are dropped."""
    state = read_checkpoint(checkpoint) if isinstance(checkpoint, (
        str, bytes, os.PathLike)) else checkpoint
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    if isinstance(state, dict) and "model" in state and all(
            not torch.is_tensor(v) for k, v in state.items() if k != "model"):
        state = state["model"]
    return {k: v.detach().cpu().numpy() for k, v in state.items()
            if torch.is_tensor(v)}


def replace_state_dict(state_dict):
    """Strip the Lightning prefixes (convert.py:56-69): ``model.`` off the
    backbone's keys with ``in_proj_ -> qkv.`` and ``out_proj -> proj``,
    and 9 characters off every other key (``cls_head.cls_head.weight ->
    cls_head.weight``)."""
    out = {}
    for old_key, v in state_dict.items():
        if old_key.startswith("model"):
            new_key = old_key[6:]
            if "in_proj" in new_key:
                new_key = new_key.replace("in_proj_", "qkv.")
            elif "out_proj" in new_key:
                new_key = new_key.replace("out_proj", "proj")
        else:
            new_key = old_key[9:]
        out[new_key] = v
    return out


def _inflate(weight, tube_size, extend_strategy):
    """A Conv2d kernel (o, i, kh, kw) -> the Conv3d tubelet kernel (o, i,
    tube_size, kh, kw): the frame repeated and divided by tube_size
    (``temporal_avg``), or in the centre frame alone (``center_frame``). The
    original repo's center_frame zeroes an expanded view of the source and
    so leaves the whole kernel zero; the JAX package writes the intended
    kernel (convert.py:91-99), and so does the port."""
    new_weight = np.repeat(weight[:, :, None], tube_size, axis=2)
    if extend_strategy == "temporal_avg":
        new_weight = new_weight / tube_size
    elif extend_strategy == "center_frame":
        new_weight = np.zeros_like(new_weight)
        new_weight[:, :, tube_size // 2] = weight
    return new_weight


def _copy_temporal(state_dict, attention_type, copy_strategy,
                   num_time_transformer_layers):
    """Divided attention: ``attentions.0`` copied to ``attentions.1``.
    fact_encoder: the first ``num_time_transformer_layers`` spatial layers
    copied to the temporal stack ``transformer_layers.1``. ``repeat``
    copies the values, ``set_zero`` writes zeros (convert.py:122-138)."""
    for old_key in list(state_dict):
        new_key = None
        if attention_type == "divided_space_time":
            if "attentions.0" in old_key:
                new_key = old_key.replace("attentions.0", "attentions.1")
        elif attention_type == "fact_encoder":
            matches = re.findall(r"(?<=layers\.)\d+", old_key)
            if len(matches) > 1 and int(matches[1]) < \
                    num_time_transformer_layers:
                new_key = old_key.replace("transformer_layers.0.layers",
                                          "transformer_layers.1.layers")
        if new_key is None:
            continue
        if copy_strategy == "repeat":
            state_dict[new_key] = state_dict[old_key].copy()
        elif copy_strategy == "set_zero":
            state_dict[new_key] = np.zeros_like(state_dict[old_key])
    return state_dict


def surgery_from_vit_pretrain(state_dict, conv_type, attention_type,
                              copy_strategy="repeat",
                              extend_strategy="temporal_avg", tube_size=2,
                              num_time_transformer_layers=4):
    """An image ViT's state dict in the original repo's naming -> the video
    model's (convert.py:72-139): the patch kernel inflated for Conv3d,
    ``transformer_layers.layers`` -> ``transformer_layers.0.layers`` for
    fact_encoder, ``in_proj_``/``out_proj`` -> ``qkv.``/``proj``,
    ``norms.{0,1}`` -> ``attentions.0.norm``/``ffns.0.norm``, then the
    temporal copies (``_copy_temporal``)."""
    state_dict = dict(state_dict)
    for old_key in list(state_dict):
        if conv_type == "Conv3d" and "patch_embed.projection.weight" in old_key:
            state_dict[old_key] = _inflate(state_dict[old_key], tube_size,
                                           extend_strategy)
            continue
        new_key = old_key
        if attention_type == "fact_encoder":
            new_key = new_key.replace("transformer_layers.layers",
                                      "transformer_layers.0.layers")
        if "in_proj" in new_key:
            new_key = new_key.replace("in_proj_", "qkv.")
        elif "out_proj" in new_key:
            new_key = new_key.replace("out_proj", "proj")
        if "norms" in new_key:
            new_key = new_key.replace("norms.0", "attentions.0.norm")
            new_key = new_key.replace("norms.1", "ffns.0.norm")
        state_dict[new_key] = state_dict.pop(old_key)
    return _copy_temporal(state_dict, attention_type, copy_strategy,
                          num_time_transformer_layers)


def surgery_from_mae_pretrain(state_dict, conv_type, attention_type,
                              copy_strategy="repeat",
                              extend_strategy="temporal_avg", tube_size=2,
                              num_time_transformer_layers=4):
    """An MAE checkpoint's state dict -> the video model's
    (convert.py:142-227): the decoder dropped, ``encoder.patch_embed.proj``
    -> ``patch_embed.projection`` (inflated for Conv3d), ``encoder.blocks``
    -> the encoder stack, ``qkv.bias`` = [q_bias, 0, v_bias], ``mlp.fc{1,2}``
    -> the FFN's linears, ``norm{1,2}`` -> the blocks' norms,
    ``encoder.norm`` -> ``norm``, then the temporal copies. The attention
    renames the original repo left commented out are applied, as in the
    JAX package."""
    state_dict = dict(state_dict)
    for old_key in list(state_dict):
        if old_key not in state_dict:  # a v_bias taken with its q_bias
            continue
        if "decoder" in old_key:
            state_dict.pop(old_key)
            continue
        if "encoder.patch_embed.proj" in old_key:
            new_key = old_key.replace("encoder.patch_embed.proj",
                                      "patch_embed.projection")
            value = state_dict.pop(old_key)
            if conv_type == "Conv3d" and "weight" in old_key:
                value = _inflate(value, tube_size, extend_strategy)
            state_dict[new_key] = value
            continue
        new_key = old_key.replace(
            "encoder.blocks", "transformer_layers.0.layers"
            if attention_type == "fact_encoder"
            else "transformer_layers.layers")
        if "norm" in new_key:
            new_key = new_key.replace("norm1", "attentions.0.norm")
            new_key = new_key.replace("norm2", "ffns.0.norm")
        elif "attn" in new_key:
            if "q_bias" in new_key:
                block = re.findall(r"(?<=blocks\.)\d+", old_key)[0]
                q = state_dict.pop(f"encoder.blocks.{block}.attn.q_bias")
                v = state_dict.pop(f"encoder.blocks.{block}.attn.v_bias")
                state_dict[new_key.replace(
                    "attn.q_bias", "attentions.0.attn.qkv.bias")] = \
                    np.concatenate([q, np.zeros_like(q), v])
                continue
            if "v_bias" in new_key:
                continue
            new_key = new_key.replace("attn.qkv", "attentions.0.attn.qkv")
            new_key = new_key.replace("attn.proj", "attentions.0.attn.proj")
        elif "mlp" in new_key:
            new_key = new_key.replace("mlp.fc1", "ffns.0.layers.0.0")
            new_key = new_key.replace("mlp.fc2", "ffns.0.layers.1")
        if "encoder.norm" in old_key:
            new_key = old_key.replace("encoder.norm", "norm")
        state_dict[new_key] = state_dict.pop(old_key)
    return _copy_temporal(state_dict, attention_type, copy_strategy,
                          num_time_transformer_layers)


def merge_state_dict(module, state_dict, verbose=True):
    """Load ``state_dict`` (arrays or tensors under the module's own names)
    into ``module`` without strictness, as the JAX package's
    ``merge_params`` does (convert.py:362-402): an entry of the module's
    shape is copied in, cast to the parameter's dtype; one of another shape
    (a ``pos_embed`` of another patch count, a ``time_embed`` of another
    frame count) is reported as unexpected, ``"<name> (shape <file> vs
    <module>)"``, and the parameter keeps its value, where
    ``load_state_dict(strict=False)`` would raise. Returns (missing,
    unexpected): the module's names the dict lacks, and the dict's names
    the module lacks or cannot take. Unlike ``merge_params``, which names
    an absent subtree once, every unexpected key is listed."""
    own = module.state_dict()
    unexpected = []
    with torch.no_grad():
        for name, value in state_dict.items():
            value = torch.as_tensor(value)
            if name not in own:
                unexpected.append(name)
            elif tuple(value.shape) != tuple(own[name].shape):
                unexpected.append(f"{name} (shape {tuple(value.shape)} vs "
                                  f"{tuple(own[name].shape)})")
            else:
                own[name].copy_(value)
    missing = [name for name in own if name not in state_dict]
    if verbose:
        print(f"missing_keys:{missing}\n unexpected_keys:{unexpected}")
    return missing, unexpected


def init_from_vit_pretrain(module, checkpoint, conv_type, attention_type,
                           copy_strategy, extend_strategy="temporal_avg",
                           tube_size=2, num_time_transformer_layers=4,
                           verbose=True):
    """An image ViT checkpoint (a path, or ``read_checkpoint``'s payload)
    into a TimeSformer or ViViT (convert.py:409-423). Returns (missing,
    unexpected)."""
    sd = surgery_from_vit_pretrain(
        load_torch_state_dict(checkpoint), conv_type, attention_type,
        copy_strategy, extend_strategy, tube_size,
        num_time_transformer_layers)
    return merge_state_dict(module, sd, verbose)


def init_from_mae_pretrain(module, checkpoint, conv_type, attention_type,
                           copy_strategy, extend_strategy="temporal_avg",
                           tube_size=2, num_time_transformer_layers=4,
                           verbose=True):
    """An MAE checkpoint into a TimeSformer or ViViT (convert.py:426-440).
    The trainer never calls it, as in the JAX package."""
    sd = surgery_from_mae_pretrain(
        load_torch_state_dict(checkpoint), conv_type, attention_type,
        copy_strategy, extend_strategy, tube_size,
        num_time_transformer_layers)
    return merge_state_dict(module, sd, verbose)


def init_from_kinetics_pretrain(module, checkpoint, verbose=True):
    """A video checkpoint of the original repo (Lightning prefixes) into
    the same model (convert.py:443-451). The JAX package's
    ``attention_type`` argument picks its flax names for a fact_encoder;
    the port's names are the checkpoint's, so it has none."""
    sd = replace_state_dict(load_torch_state_dict(checkpoint))
    return merge_state_dict(module, sd, verbose)


# A MaskFeat/MViT checkpoint in pytorchvideo's names into MaskFeat
# (convert.py:248-258). The JAX package's surgery_maskfeat_keys renames
# pytorchvideo's patch_embed.patch_model, mlp.fc{1,2} and
# attn.pool_{q,k,v}.weight to its flax modules' names; the port's modules
# carry pytorchvideo's names, so all three renames are the identity here and
# the import is the Kinetics one.
init_maskfeat_from_kinetics_pretrain = init_from_kinetics_pretrain


def save_reference_checkpoint(model, path, cls_head=None):
    """Write a ``.pth`` the original repo (and the JAX package's imports)
    load: ``{"state_dict": {"model.<name>": ..., "cls_head.<name>": ...}}``
    in fp32, the layout of the JAX package's ``save_torch_checkpoint``
    (convert.py:540-559), whose ``replace_state_dict`` strips the prefixes.
    The port's names are the original repo's (pytorchvideo's for
    MaskFeat), so no renaming and no ``arch`` argument are needed; the head
    is written as ``cls_head.`` + the head module's names
    (``cls_head.cls_head.weight``), as the JAX package writes its flax
    head."""
    sd = {f"model.{k}": v.detach().float().cpu().contiguous()
          for k, v in model.state_dict().items()}
    if cls_head is not None:
        sd.update({f"cls_head.{k}": v.detach().float().cpu().contiguous()
                   for k, v in cls_head.state_dict().items()})
    torch.save({"state_dict": sd}, path)
