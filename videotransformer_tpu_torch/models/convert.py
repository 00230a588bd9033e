"""JAX package parameters (numpy) -> the port's ``state_dict``.

The input is the flat ``{"a/b/c": ndarray}`` form of
``videotransformer_tpu/serving/export.py::flatten_params``, as stored in a
serving artifact's ``params.npz`` under the ``model/`` and ``head/``
prefixes. The output names are those of
``videotransformer_tpu.models.convert.flax_to_torch_state_dict`` (the
original PyTorch repo's), which the port's modules use, so
``load_state_dict(strict=True)`` takes them.

This is a port, not an import: importing ``videotransformer_tpu.models``
needs jax and flax, which the card's machine does not have.
"""

import re

import numpy as np

_INDEXED = re.compile(r"(layers|attentions|ffns|blocks)_(\d+)")


def _leaf(name, value):
    """flax leaf -> torch (name, array): Linear kernels (in, out) -> (out, in),
    Conv2d kernels (kh, kw, in, out) -> (out, in, kh, kw), LayerNorm scale ->
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
    last sits in a ``Sequential``: ``layers_i -> layers.i.0``."""
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
                names.append(part)
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
