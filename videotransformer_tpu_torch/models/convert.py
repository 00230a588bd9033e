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

This is a port, not an import: importing ``videotransformer_tpu.models``
needs jax and flax, which the card's machine does not have.
"""

import re

import numpy as np

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
