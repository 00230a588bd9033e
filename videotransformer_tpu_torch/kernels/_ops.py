"""The kernels' forwards as dispatcher ops in the ``vt`` namespace.

Each of ``vt::fused_prenorm_mhsa`` (B1), ``vt::fused_prenorm_ffn`` (B2) and
``vt::flash_attention`` (B5) is defined once here and given three
implementations by its kernel module: the ``CPU`` key runs the plain
version, the ``CUDA`` key the hand-written kernel's wrapper (which counts
its launches), and ``register_fake`` the shape function that ``torch.export``
and the fake-tensor checks trace with. The dispatcher picks by the tensors'
device: there is no device test in the callers, and a tensor on any other
device finds no kernel and raises. So a program exported once holds the ops
as nodes and runs the kernel on the card and the plain version on the CPU.

The ops are ``torch.library.Library`` ``define``/``impl`` registrations, not
``torch.library.custom_op``, whose Python wrapper runs on every call and
adds host time to a train step that is already host-held
(``tools/fused_bench.py``'s ``issue_us`` reads a call's host time). Outputs
a mode does not write are empty tensors, never None, so each op has one
schema in every mode.
"""

import torch
from torch._subclasses.fake_tensor import is_fake

NAMESPACE = "vt"
LIB = torch.library.Library(NAMESPACE, "DEF")


def define(name, schema, cpu, cuda, fake):
    """``vt::<name>`` with ``schema`` (the part after the name), the plain
    version ``cpu``, the kernel's wrapper ``cuda`` and the shape function
    ``fake``; returns the op's default overload."""
    LIB.define(f"{name}{schema}")
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", _traced_only(
        name, fake), lib=LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def _traced_only(name, fake):
    """``fake`` for fake tensors (a trace); a real tensor on the meta device,
    which the fake implementation would otherwise serve too, is refused as
    every device but the CPU and the card is."""
    def shapes(*args):
        for a in args:
            if isinstance(a, torch.Tensor) and not is_fake(a):
                raise ValueError(f"{NAMESPACE}::{name}: a tensor is on "
                                 f"{a.device}, expected cuda or the CPU")
        return fake(*args)
    return shapes


def empty(like, dtype=None):
    """The (0,) tensor an op returns for an output its mode does not write."""
    return like.new_empty((0,), dtype=dtype or like.dtype)


def is_op(target):
    """Whether a graph node's target is one of these ops."""
    return (isinstance(target, torch._ops.OpOverload)
            and target.namespace == NAMESPACE)
