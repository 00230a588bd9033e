"""Process groups for data and tensor parallelism, and the collectives the
trainer and the blocks run over them.

Port of ``videotransformer_tpu/parallel/mesh.py`` in PyTorch's idiom: one
process a card (``torchrun`` sets ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``; the process trains on ``cuda:LOCAL_RANK``), and a
``torch.distributed`` group for each axis of the JAX mesh that the port
runs, ``data`` and ``model``:

- ``create_mesh(data, model)`` keeps the JAX axis order (data slowest): the
  ``model`` ranks of one data slot are consecutive, so on a node of several
  cards tensor parallelism stays inside the node's NVLink domain, and the
  gradient sums over ``data`` take the longer path;
- ``shard_batch`` is ``shard_local_batch``'s counterpart for a caller that
  holds a global batch: this data rank's rows;
- ``broadcast_state`` sends rank 0's initial parameters to every rank
  (``replicate``'s role);
- ``even_eval_batches`` gives every data rank the same number of eval
  batches of the same size, padded with label -1 (``pad_eval_batch``, the
  JAX trainer's padding), whatever its ``Loader`` shard held;
- ``partner_rows`` exchanges a rank's rows with the data rank that holds
  their mixup partners, and that rank alone.

The backend is NCCL when each rank has a card of its own. A caller may name
gloo instead (the CPU tests, two processes sharing one card); gloo takes
CUDA tensors in ``all_reduce`` and ``broadcast`` only, so every collective
here is built on those two, and tensors stay on the rank's device whatever
the backend.

A model is built with its mesh (``models/timesformer.py``, ``vivit.py``,
``maskfeat.py``), which its blocks keep: a block's model group for tensor
parallelism, and the data rank for the random draws. A step draws every
random number for the global batch and takes its data rank's rows
(``rand_rows``, ``shard_batch``), so DropPath masks, mixup and the device
augment's draws are those of one process on the global batch. A model
built without a mesh (serving, a single-process trainer) runs as one
process.
"""

import datetime
import os

import torch
import torch.distributed as dist


class Mesh:
    """This process's place in a (data, model) grid of ``data · model``
    ranks: global rank = data_rank · model + model_rank. ``pair_group``
    joins this rank to the one of data rank ``data - 1 - data_rank`` (None
    where that is this rank): mixup's partner (``partner_rows``)."""

    def __init__(self, data, model, rank, data_group, model_group,
                 device="cpu", pair_group=None):
        self.data, self.model = data, model
        self.device = torch.device(device)
        self.rank = rank
        self.data_rank, self.model_rank = divmod(rank, model)
        self.data_group, self.model_group = data_group, model_group
        self.pair_group = pair_group
        # global ranks of this rank's data group and of its model group
        self.data_ranks = [d * model + self.model_rank for d in range(data)]
        self.model_ranks = [self.data_rank * model + m for m in range(model)]

    def __repr__(self):
        return (f"Mesh(data={self.data}, model={self.model}, rank={self.rank}"
                f", data_rank={self.data_rank}, model_rank={self.model_rank})")


def model_ranks(mesh):
    """The tensor-parallel degree of ``mesh`` (1 without one)."""
    return 1 if mesh is None else mesh.model


def init_distributed(backend=None, init_method=None, rank=None,
                     world_size=None, device=None, timeout_s=600):
    """Join the process group of a multi-process run and return this
    process's device.

    Without arguments it reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, and ``MASTER_ADDR``/``MASTER_PORT`` for
    the ``env://`` rendezvous) and does nothing in a single process (no
    ``WORLD_SIZE`` above 1), returning ``device``. ``device`` "cuda" (the
    default where a card is visible) becomes ``cuda:LOCAL_RANK``; the
    backend is then NCCL, else gloo, unless ``backend`` names one."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if init_method is None and world_size <= 1:
        return device
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
    return device


def create_mesh(data=-1, model=1, device="cpu"):
    """The data, model and mixup-pair groups of this rank over the
    initialised process group (``data=-1``: the world over ``model``), its
    tensors on ``device``. Every rank calls it, in the same order, as
    ``torch.distributed.new_group`` requires."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs torch.distributed initialised "
                           "(init_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if data == -1:
        if world % model:
            raise ValueError(f"world {world} is not a multiple of model "
                             f"{model}")
        data = world // model
    if data * model != world:
        raise ValueError(f"data {data} x model {model} != world {world}")
    model_groups = [dist.new_group([d * model + m for m in range(model)])
                    for d in range(data)]
    data_groups = [dist.new_group([d * model + m for d in range(data)])
                   for m in range(model)]
    pair_groups = {}
    for m in range(model):
        for d in range(data // 2):
            pair = [d * model + m, (data - 1 - d) * model + m]
            group = dist.new_group(pair)
            pair_groups.update(dict.fromkeys(pair, group))
    return Mesh(data, model, rank, data_groups[rank % model],
                model_groups[rank // model], device, pair_groups.get(rank))


def rand_rows(shape, generator, dtype, device, mesh=None):
    """``torch.rand(shape)`` of this data rank's rows of the global draw:
    the draw is made for ``shape[0] · data ranks`` rows and cut, so every
    rank draws what one process draws for the global batch."""
    if mesh is None or mesh.data == 1:
        return torch.rand(shape, generator=generator, dtype=dtype,
                          device=device)
    u = torch.rand((shape[0] * mesh.data,) + tuple(shape[1:]),
                   generator=generator, dtype=dtype, device=device)
    return shard_batch(mesh, u)


def shard_batch(mesh, batch):
    """This data rank's rows (the leading dim, split evenly) of ``batch``,
    a global batch or draw: a numpy array or tensor, or a dict of them."""
    if mesh is None or mesh.data == 1:
        return batch

    def cut(t):
        if t.shape[0] % mesh.data:
            raise ValueError(f"{t.shape[0]} rows do not split over "
                             f"{mesh.data} data ranks")
        n = t.shape[0] // mesh.data
        return t[mesh.data_rank * n:(mesh.data_rank + 1) * n]

    return {k: cut(v) for k, v in batch.items()} \
        if isinstance(batch, dict) else cut(batch)


def pad_eval_batch(batch, size, n_crops=1):
    """``batch`` ({"video" (B·n_crops, ...) or "raw_video" (B, ...),
    "label" (B,)}, tensors) padded to ``size`` samples as the JAX trainer
    pads an eval batch (trainer.py:472-499): label -1, which counts
    nowhere, and zero clips."""
    pad = size - batch["label"].shape[0]
    if pad == 0:
        return batch
    out = {}
    for k, v in batch.items():
        rows = pad * (n_crops if k == "video" else 1)
        out[k] = torch.cat([v, torch.full(
            (rows,) + tuple(v.shape[1:]), -1 if k == "label" else 0,
            dtype=v.dtype, device=v.device)])
    return out


def broadcast_(tensors, src=0, group=None):
    """Broadcast each tensor in place from global rank ``src``."""
    for t in tensors:
        dist.broadcast(t, src=src, group=group)


def broadcast_state(module):
    """Rank 0's parameters and buffers to every rank, in place."""
    broadcast_([t.data for t in module.state_dict().values()])


def all_reduce_coalesced(tensors, group):
    """Sum each tensor in place over ``group``: one all-reduce of the
    concatenation of each dtype's tensors, in the order given (the same
    order, and so the same bits, at every step)."""
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        torch._foreach_copy_(same, [
            v.view_as(t)
            for v, t in zip(flat.split([t.numel() for t in same]), same)])


def all_gather(x, ranks, group):
    """The concatenation along dim 0 of ``x`` from each of ``ranks`` (global
    ranks, in order; every one holds the same shape), by one broadcast from
    each: the bits of every part are its owner's."""
    me = dist.get_rank()
    parts = []
    for src in ranks:
        buf = x.contiguous().clone() if src == me else torch.empty_like(
            x, memory_format=torch.contiguous_format)
        dist.broadcast(buf, src=src, group=group)
        parts.append(buf)
    return torch.cat(parts)


class _GatherData(torch.autograd.Function):
    """All-gather over the data group forward; the gradient summed over the
    data group and cut to this rank's rows backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[0]
        return all_gather(x, mesh.data_ranks, mesh.data_group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.data_group)
        r, n = ctx.mesh.data_rank, ctx.n
        return g[r * n:(r + 1) * n], None


def gather_data(x, mesh):
    """``x``'s rows from every data rank of ``mesh``, in data-rank order
    (the global batch's rows); ``x`` itself without one. Gradients flow
    back to the rank that holds each row."""
    if mesh is None or mesh.data == 1:
        return x
    return _GatherData.apply(x, mesh)


def sum_over_data(t, mesh):
    """``t`` summed over the data group of ``mesh`` (no gradient); ``t``
    itself without one."""
    if mesh is None or mesh.data == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=mesh.data_group)
    return t


def partner_rows(x, mesh):
    """The ``x`` of data rank ``data - 1 - data_rank`` (the same shape on
    both), exchanged with that rank alone: the rows that global row i's
    partner B - 1 - i lies in, for mixup (JAX mixup.py:76 flips the global
    batch). ``x`` itself on the middle rank of an odd data group."""
    if mesh.pair_group is None:
        return x
    other = (mesh.data - 1 - mesh.data_rank) * mesh.model + mesh.model_rank
    x = x.contiguous()
    out = torch.empty_like(x)
    for src in sorted((mesh.rank, other)):
        dist.broadcast(x if src == mesh.rank else out, src=src,
                       group=mesh.pair_group)
    return out


def even_eval_batches(batches, mesh, device, n_crops=1):
    """The eval ``batches`` of this data rank (device tensors, {"video" or
    "raw_video", "label"}) as the data group must run them: round by round,
    every rank a batch of the round's largest size, a short one padded and
    a rank whose shard has run out given padding alone (``pad_eval_batch``:
    label -1, zero clips), until every shard has run out. Each round agrees
    on the size, the clip key and the clip shape by one all-reduce (max)
    over the data group, so a rank with no sample at all still pads. The
    data ranks' shards may differ in size: ``Loader`` splits a set that does
    not divide by the data ranks unevenly."""
    if mesh is None or mesh.data == 1:
        yield from batches
        return
    batches = iter(batches)
    while True:
        batch = next(batches, None)
        desc = torch.zeros(6, dtype=torch.int64, device=device)
        if batch is not None:
            key = "raw_video" if "raw_video" in batch else "video"
            desc[0] = batch["label"].shape[0]
            desc[1] = key == "raw_video"
            desc[2:] = torch.tensor(batch[key].shape[1:])
        dist.all_reduce(desc, op=dist.ReduceOp.MAX, group=mesh.data_group)
        size, raw, *shape = desc.tolist()
        if size == 0:
            return
        if batch is None:
            key = "raw_video" if raw else "video"
            batch = {key: torch.zeros(
                [0] + shape, device=device,
                dtype=torch.uint8 if raw else torch.float32),
                "label": torch.zeros(0, dtype=torch.int32, device=device)}
        yield pad_eval_batch(batch, size, n_crops)


def barrier(mesh):
    """Wait for every rank (an all-reduce of one element, which each backend
    takes on the rank's device)."""
    if mesh is not None:
        dist.all_reduce(torch.zeros(1, device=mesh.device))
