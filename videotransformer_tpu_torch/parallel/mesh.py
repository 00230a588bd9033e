"""Process groups for data, sequence, tensor and pipeline parallelism, and
the collectives the trainer and the blocks run over them.

Port of ``videotransformer_tpu/parallel/mesh.py`` in PyTorch's idiom: one
process a card (``torchrun`` sets ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``; the process trains on ``cuda:LOCAL_RANK``), and a
``torch.distributed`` group for each axis of the JAX mesh, ``data``,
``seq``, ``model`` and ``pipe``:

- ``create_mesh(data, model, seq, pipe)`` keeps the JAX axis order (data
  slowest, pipe fastest, mesh.py:23-44): the ``pipe`` ranks of one (data,
  seq, model) slot are consecutive, then the ``model`` ranks, then the
  ``seq`` ranks of a data slot, so on a node of several cards the stage
  moves, tensor and sequence parallelism stay inside the node's NVLink
  domain, and the gradient sums over ``data`` take the longer path. The
  pipe axis is there only when ``pipe`` > 1; at 1 every rank and group is
  what it was without it;
- ``shard_batch`` is ``shard_local_batch``'s counterpart for a caller that
  holds a global batch: this data rank's rows (the same on every seq and
  model rank of it);
- ``broadcast_state`` sends rank 0's initial parameters to every rank
  (``replicate``'s role);
- ``even_eval_batches`` gives every data rank the same number of eval
  batches of the same size, padded with label -1 (``pad_eval_batch``, the
  JAX trainer's padding), whatever its ``Loader`` shard held;
- ``partner_rows`` exchanges a rank's rows with the data rank that holds
  their mixup partners, and that rank alone;
- ``all_to_all`` and ``ring_shift`` move activations between the seq ranks
  (``parallel/sp.py``), each an autograd Function whose backward is the
  inverse move; ``sum_over_seq`` and ``gather_seq`` are an all-reduce and
  an all-gather over them whose backward is an all-reduce;
- ``send_stage`` and ``recv_stage`` move a microbatch's activations, or
  their gradient, between adjacent pipeline stages (``parallel/pp.py``),
  in the working dtype, over the two-rank group of the pair.

The backend is NCCL when each rank has a card of its own. A caller may name
gloo instead (the CPU tests, two processes sharing one card); gloo takes
CUDA tensors in ``all_reduce`` and ``broadcast`` only. So every collective
here has a form built on those two, and the seq moves also have the NCCL
form (``all_to_all_single``, ``batch_isend_irecv``), as do the stage
moves (``send``/``recv``): the backend of the group picks one
(``p2p_form``), and neither gives way to the other. Tensors
stay on the rank's device whatever the backend.

A model is built with its mesh (``models/timesformer.py``, ``vivit.py``,
``maskfeat.py``), which its blocks keep: a block's model group for tensor
parallelism, its seq group for sequence parallelism, and the data and seq
ranks for the random draws. A step draws every random number for the
global batch and takes its rank's rows (``rand_rows``, ``shard_batch``),
so DropPath masks, mixup and the device augment's draws are those of one
process on the global batch. A model built without a mesh (serving, a
single-process trainer) runs as one process.
"""

import datetime
import os

import torch
import torch.distributed as dist


class Mesh:
    """This process's place in a (data, seq, model, pipe) grid of ``data ·
    seq · model · pipe`` ranks: global rank = ((data_rank · seq + seq_rank)
    · model + model_rank) · pipe + pipe_rank, the JAX mesh's order. The
    groups: ``data_group`` (the data ranks at this seq, model and pipe
    rank), ``seq_group`` (the seq ranks at this data, model and pipe rank),
    ``model_group`` (the model ranks at this data, seq and pipe rank),
    ``replica_group`` (the data and seq ranks at this model and pipe rank:
    the gradient sum of a sequence-parallel model) and ``pipe_group`` (the
    pipe ranks at this data, seq and model rank). ``pair_group`` joins
    this rank to the one of data rank ``data - 1 - data_rank`` at the same
    seq, model and pipe rank (None where that is this rank): mixup's
    partner (``partner_rows``). ``stage_groups`` maps each adjacent pipe
    rank (``pipe_rank`` ± 1) to the two-rank group of the pair, which
    carries the stage moves (``send_stage``, ``recv_stage``)."""

    def __init__(self, data, model, rank, data_group, model_group,
                 device="cpu", pair_group=None, seq=1, seq_group=None,
                 replica_group=None, pipe=1, pipe_group=None,
                 stage_groups=None):
        self.data, self.seq, self.model, self.pipe = data, seq, model, pipe
        self.device = torch.device(device)
        self.rank = rank
        slot, self.pipe_rank = divmod(rank, pipe)
        slot, self.model_rank = divmod(slot, model)
        self.data_rank, self.seq_rank = divmod(slot, seq)
        self.data_group, self.model_group = data_group, model_group
        self.seq_group = seq_group
        self.replica_group = replica_group
        self.pair_group = pair_group
        self.pipe_group = pipe_group
        self.stage_groups = stage_groups or {}
        # global ranks of this rank's data, seq, model and pipe groups
        at = lambda d, s, m, p=self.pipe_rank: ((d * seq + s) * model + m) \
            * pipe + p
        self.data_ranks = [at(d, self.seq_rank, self.model_rank)
                           for d in range(data)]
        self.seq_ranks = [at(self.data_rank, s, self.model_rank)
                          for s in range(seq)]
        self.model_ranks = [at(self.data_rank, self.seq_rank, m)
                            for m in range(model)]
        self.pipe_ranks = [at(self.data_rank, self.seq_rank,
                              self.model_rank, p) for p in range(pipe)]

    def __repr__(self):
        return (f"Mesh(data={self.data}, seq={self.seq}, model={self.model}, "
                f"pipe={self.pipe}, rank={self.rank}, data_rank="
                f"{self.data_rank}, seq_rank={self.seq_rank}, model_rank="
                f"{self.model_rank}, pipe_rank={self.pipe_rank})")


def model_ranks(mesh):
    """The tensor-parallel degree of ``mesh`` (1 without one)."""
    return 1 if mesh is None else mesh.model


def seq_ranks(mesh):
    """The sequence-parallel degree of ``mesh`` (1 without one)."""
    return 1 if mesh is None else mesh.seq


def init_distributed(backend=None, init_method=None, rank=None,
                     world_size=None, device="cuda", timeout_s=600):
    """Join the process group of a multi-process run and return this
    process's device.

    Without arguments it reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, and ``MASTER_ADDR``/``MASTER_PORT`` for
    the ``env://`` rendezvous) and does nothing in a single process (no
    ``WORLD_SIZE`` above 1), returning ``device``. ``device`` "cuda" (the
    default) needs a visible card (``utils/helpers.resolve_device``: no
    card raises, nothing lands on the CPU unasked) and becomes
    ``cuda:LOCAL_RANK``; the backend is then NCCL, else gloo, unless
    ``backend`` names one."""
    # helpers imports the optimizer, which imports this module
    from videotransformer_tpu_torch.utils.helpers import resolve_device

    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    device = resolve_device(device)
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


def create_mesh(data=-1, model=1, device="cpu", seq=1, pipe=1):
    """The data, seq, model, pipe, replica, mixup-pair and stage-pair
    groups of this rank over the initialised process group (``data=-1``:
    the world over ``seq · model · pipe``), its tensors on ``device``.
    Every rank calls it, in the same order, as
    ``torch.distributed.new_group`` requires; the pipe axis adds its groups
    after the others, so with ``pipe`` = 1 the groups are made as they
    were without it."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs torch.distributed initialised "
                           "(init_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if data == -1:
        if world % (seq * model * pipe):
            raise ValueError(f"world {world} is not a multiple of seq {seq} "
                             f"x model {model} x pipe {pipe}")
        data = world // (seq * model * pipe)
    if data * seq * model * pipe != world:
        raise ValueError(f"data {data} x seq {seq} x model {model} x pipe "
                         f"{pipe} != world {world}")
    at = lambda d, s, m, p: ((d * seq + s) * model + m) * pipe + p
    grid = [(d, s, m, p) for d in range(data) for s in range(seq)
            for m in range(model) for p in range(pipe)]
    d0, s0, m0, p0 = grid[rank]

    def groups(key):
        """One group for each value of ``key`` (every rank builds every
        group, in the same order); this rank's."""
        mine = None
        for k in dict.fromkeys(key(*c) for c in grid):
            ranks = [at(*c) for c in grid if key(*c) == k]
            group = dist.new_group(ranks)
            if k == key(d0, s0, m0, p0):
                mine = group
        return mine

    def pairs(pairs_of):
        """A two-rank group for each pair of ``pairs_of`` (in order);
        {the other rank: the group} of this rank's."""
        mine = {}
        for a, b in pairs_of:
            group = dist.new_group([a, b])
            if rank in (a, b):
                mine[b if rank == a else a] = group
        return mine

    model_group = groups(lambda d, s, m, p: (d, s, p))
    data_group = groups(lambda d, s, m, p: (s, m, p))
    seq_group = groups(lambda d, s, m, p: (d, m, p)) if seq > 1 else None
    replica_group = groups(lambda d, s, m, p: (m, p)) if seq > 1 \
        else data_group
    pair_group = next(iter(pairs(
        (at(d, s, m, p), at(data - 1 - d, s, m, p)) for p in range(pipe)
        for s in range(seq) for m in range(model)
        for d in range(data // 2)).values()), None)
    pipe_group, stage_groups = None, {}
    if pipe > 1:
        pipe_group = groups(lambda d, s, m, p: (d, s, m))
        stage_groups = {q % pipe: g for q, g in pairs(
            (at(d, s, m, p), at(d, s, m, p + 1)) for d in range(data)
            for s in range(seq) for m in range(model)
            for p in range(pipe - 1)).items()}
    return Mesh(data, model, rank, data_group, model_group, device,
                pair_group, seq=seq, seq_group=seq_group,
                replica_group=replica_group, pipe=pipe, pipe_group=pipe_group,
                stage_groups=stage_groups)


def rand_rows(shape, generator, dtype, device, mesh=None, clips=None):
    """``torch.rand(shape)`` of this rank's rows of the global draw: the
    draw is made for the global batch and cut, so every rank draws what one
    process draws for the global batch. The rows are this data rank's
    (``shape[0]`` of them, the same on each of its seq ranks) or, with
    ``clips``, rows (clip, k) whose k is split over the seq ranks:
    ``shape[0] = clips · k``, this data rank's clips and this seq rank's k
    (temporal rows over patches, spatial rows over frames). Those are not
    a contiguous slice of the flat draw. ``generator`` is a
    ``torch.Generator``, None (the default one), or a source of uniforms
    drawn before that cuts them itself: ``generator.rand_rows(shape, dtype,
    device)`` (a pipeline stage's, ``parallel/pp.py::RowDraws``)."""
    if not (generator is None or isinstance(generator, torch.Generator)):
        return generator.rand_rows(shape, dtype, device)
    data = 1 if mesh is None else mesh.data
    seq = 1 if mesh is None or clips is None else mesh.seq
    if data * seq == 1:
        return torch.rand(shape, generator=generator, dtype=dtype,
                          device=device)
    rest = tuple(shape[1:])
    u = torch.rand((shape[0] * data * seq,) + rest, generator=generator,
                   dtype=dtype, device=device)
    if seq == 1:
        return shard_batch(mesh, u)
    u = u.reshape((data, clips, seq, shape[0] // clips) + rest)
    return u[mesh.data_rank, :, mesh.seq_rank].reshape(shape)


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
    other = mesh.data_ranks[mesh.data - 1 - mesh.data_rank]
    x = x.contiguous()
    out = torch.empty_like(x)
    for src in sorted((mesh.rank, other)):
        dist.broadcast(x if src == mesh.rank else out, src=src,
                       group=mesh.pair_group)
    return out


def p2p_form(group):
    """Whether the seq and stage moves over ``group`` take the NCCL form
    (``all_to_all_single``, ``batch_isend_irecv``, ``send``/``recv``); else
    the form built on broadcasts, which gloo takes with CUDA tensors."""
    return dist.get_backend(group) == "nccl"


def _stacked(parts):
    return torch.stack([p.contiguous() for p in parts])


def _exchange(parts, mesh):
    """All-to-all of ``parts`` (one equally shaped tensor for each seq
    rank, in order) over the seq group: the parts addressed to this rank,
    from each seq rank in order."""
    send = _stacked(parts)
    if p2p_form(mesh.seq_group):
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=mesh.seq_group)
        return recv.unbind(0)
    got = all_gather(send[None], mesh.seq_ranks, mesh.seq_group)
    return got[:, mesh.seq_rank].unbind(0)


def _all_to_all(x, mesh, split_dim, cat_dim):
    parts = _exchange(x.chunk(mesh.seq, split_dim), mesh)
    return torch.cat(parts, cat_dim)


class _AllToAll(torch.autograd.Function):
    """``x`` split along ``split_dim`` into one part for each seq rank, the
    parts exchanged, those received concatenated along ``cat_dim``; the
    backward is the inverse exchange."""

    @staticmethod
    def forward(ctx, x, mesh, split_dim, cat_dim):
        ctx.mesh, ctx.dims = mesh, (split_dim, cat_dim)
        return _all_to_all(x, mesh, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return _all_to_all(g, ctx.mesh, cat_dim, split_dim), None, None, None


def all_to_all(x, mesh, split_dim, cat_dim):
    """``x`` cut into ``mesh.seq`` equal parts along ``split_dim``, part j
    sent to seq rank j, and the parts this rank receives concatenated
    along ``cat_dim`` in seq-rank order: between the temporal layout
    (patches over seq) and the spatial one (frames over seq). Gradients
    take the inverse move."""
    if seq_ranks(mesh) == 1:
        return x
    return _AllToAll.apply(x, mesh, split_dim, cat_dim)


def _shift(x, mesh, step):
    """The ``x`` of seq rank ``seq_rank - step`` (mod seq): each rank sends
    to the rank ``step`` after it."""
    dst = mesh.seq_ranks[(mesh.seq_rank + step) % mesh.seq]
    src = mesh.seq_ranks[(mesh.seq_rank - step) % mesh.seq]
    x = x.contiguous()
    if p2p_form(mesh.seq_group):
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, dst, mesh.seq_group),
               dist.P2POp(dist.irecv, out, src, mesh.seq_group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out
    got = all_gather(x[None], mesh.seq_ranks, mesh.seq_group)
    return got[mesh.seq_ranks.index(src)]


class _RingShift(torch.autograd.Function):
    """The previous seq rank's ``x`` forward (each rank sends to the next);
    the gradient sent back to the previous rank backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _shift(x, mesh, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.mesh, -1), None


def ring_shift(x, mesh):
    """The ``x`` of seq rank ``seq_rank - 1`` (mod seq): one step of the
    ring of ``parallel/sp.py::ring_prenorm_mhsa`` (JAX's ``ppermute`` to
    the next rank). Gradients go round the other way."""
    if seq_ranks(mesh) == 1:
        return x
    return _RingShift.apply(x, mesh)


def send_stage(x, mesh, stage):
    """Send ``x`` to pipe rank ``stage`` (``pipe_rank`` ± 1) of this rank's
    pipe group, in its dtype; the receiver calls ``recv_stage`` with x's
    shape and dtype. NCCL: ``send``; else a broadcast from this rank in the
    pair's two-rank group."""
    group = mesh.stage_groups[stage]
    x = x.contiguous()
    if p2p_form(group):
        dist.send(x, mesh.pipe_ranks[stage], group=group)
    else:
        dist.broadcast(x, src=mesh.rank, group=group)


def recv_stage(shape, dtype, mesh, stage):
    """The tensor of ``shape`` and ``dtype`` that pipe rank ``stage``
    (``pipe_rank`` ± 1) sends with ``send_stage``, on this rank's
    device."""
    group = mesh.stage_groups[stage]
    out = torch.empty(shape, dtype=dtype, device=mesh.device)
    if p2p_form(group):
        dist.recv(out, mesh.pipe_ranks[stage], group=group)
    else:
        dist.broadcast(out, src=mesh.pipe_ranks[stage], group=group)
    return out


class _SumOverSeq(torch.autograd.Function):
    """All-reduce (sum) over the seq group forward and backward: every seq
    rank holds the sum, and each rank's gradient of it reaches every
    term."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        x = x.clone()
        dist.all_reduce(x, group=mesh.seq_group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.seq_group)
        return g, None


def sum_over_seq(x, mesh):
    """``x`` summed over the seq group of ``mesh``, on every seq rank, with
    its gradient summed the same way (the replicated rows' share of each
    rank, ``parallel/sp.py``); ``x`` itself without one."""
    if seq_ranks(mesh) == 1:
        return x
    return _SumOverSeq.apply(x, mesh)


class _GatherSeq(torch.autograd.Function):
    """All-gather over the seq group along ``dim`` forward; the gradient
    summed over the seq group and cut to this rank's part backward."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        parts = all_gather(x.movedim(dim, 0)[None], mesh.seq_ranks,
                           mesh.seq_group)
        return torch.cat(parts.unbind(0), 0).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.seq_group)
        r, n = ctx.mesh.seq_rank, ctx.n
        return g.narrow(ctx.dim, r * n, n), None, None


def gather_seq(x, mesh, dim):
    """``x``'s parts from every seq rank of ``mesh``, concatenated along
    ``dim`` in seq-rank order, on every seq rank; ``x`` itself without
    one. Gradients flow back to the rank that holds each part."""
    if seq_ranks(mesh) == 1:
        return x
    return _GatherSeq.apply(x, mesh, dim)


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
