"""The train driver: the port's trainer stepping over its prefetch, on one
card or data-parallel over several (one process a card, NCCL).

Traffic parameters (``vtbench/traffic/<mix>.json``):

- ``clips_per_step``: clips a step on each card; ``pool_batches``:
  distinct global batches made from the seed in set-up, held in pinned
  host memory and cycled (the first three steps take batches 0, 1, 2);
- ``lr``, ``wd``: the step's learning rate and weight decay;
- ``warmup_steps``: steps after the three checked ones, before the
  window; ``trace_steps``: steps in the traced window of ``--trace 1``;
- ``rate_metric``: the end-to-end metric the window's rate is reported
  under; ``reference_chunk``: clips a reference forward takes at once.

Set-up builds the trainer once (``VideoTransformerTrainer`` with the
configuration's ``trainer`` flags), puts the benchmark's weights into it,
and drives that same object through the window's own feed
(``device_prefetch`` over the pool) for the three checked steps, then the
warm-up; the window counts every clip stepped until ``--seconds`` have
passed, after a synchronize. Under data parallelism rank 0 decides when
the window ends and tells the others over a gloo group each step, so
every rank runs the same steps; the window starts and ends with a
barrier, and its rate is the global one. The trace run also profiles
``trace_steps`` further steps. Once the window has closed and the
program's state is freed, the reference follows the three checked steps
on rank 0's card.
"""

import gc
import itertools
import os
import socket
import sys
import time
from types import SimpleNamespace

import torch

from vtbench import compare, devices, harness, seeds, tracing
from vtbench.drivers import prebuild_kernels
from vtbench.reference import optim, precision
from vtbench.spans import Spans

KERNELS = ("fused_mhsa", "fused_mhsa_bwd", "fused_ffn", "fused_ffn_bwd",
           "flash_attention", "flash_attention_bwd")
CHECKED_STEPS = 3


def step_seed(seed):
    """The seed the trainer's per-step generator starts from."""
    return seeds.derive(seed, "steps") % (1 << 62)


def trainer_configs(cell, seed):
    tr = cell.traffic
    aug = cell.config["augment"]
    flags = dict(cell.config["trainer"])
    flags.update(aug_scale=tuple(aug["scale"]), aug_hflip=aug["hflip"],
                 aug_color=tuple(aug["color"]),
                 auto_augment="rand-m9-n2" if aug["auto_augment"] else None)
    flags.update(batch_size=tr["clips_per_step"], lr=tr["lr"],
                 weight_decay=tr["wd"], weight_decay_end=tr["wd"],
                 seed=step_seed(seed))
    return SimpleNamespace(**flags)


# ------------------------------------------------------------ the data

def chunk(cell, seed, batch, part, device):
    """Clips ``part`` of global batch ``batch`` (``clips_per_step`` clips)
    on ``device``, made from the seed: uint8 noise clips, and labels or
    MaskFeat's masks and cube markers."""
    cfg, tr = cell.config, cell.traffic
    n = tr["clips_per_step"]
    h, w = cfg["raw_hw"]
    g = seeds.generator(device, seed, "clips", batch, part)
    raw = torch.randint(0, 256, (n, cfg["num_frames"], h, w, 3),
                        generator=g, device=device, dtype=torch.uint8)
    out = {"raw_video": raw}
    if cfg["trainer"]["objective"] == "mim":
        from vtbench import masks

        grid = cfg["img_size"] // 16
        m, markers, count = masks.draw(seeds.rng(seed, "masks", batch, part),
                                       n, cfg["num_frames"] // 2, grid)
        out.update(mask=torch.from_numpy(m).to(device),
                   cube_marker=torch.from_numpy(markers).to(device),
                   cube_count=torch.from_numpy(count).to(device))
    else:
        out["label"] = torch.randint(0, cfg["num_class"], (n,), generator=g,
                                     device=device, dtype=torch.int32)
    return out


def global_batch(cell, seed, batch, world, device):
    parts = [chunk(cell, seed, batch, r, device) for r in range(world)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def host_pool(cell, seed, rank, device):
    """This rank's part of every pool batch, in pinned host memory."""
    pool = []
    for i in range(cell.traffic["pool_batches"]):
        part = chunk(cell, seed, i, rank, device)
        pool.append({k: devices.pinned_copy(v) for k, v in part.items()})
    devices.sync(device)
    return pool


# ------------------------------------------------------------ the program

def load_weights(trainer, cell, seed, device):
    """The benchmark's weights into the trainer's parameters; refuses a
    program whose parameters are not the configuration's."""
    specs = cell.model.reference.param_specs(cell.config)
    params = trainer.optimizer.params
    mine = {n: tuple(p.shape) for n, p in params.items()}
    want = {n: tuple(s) for n, (s, _, _) in specs.items()}
    if mine != want:
        diff = sorted(set(mine.items()) ^ set(want.items()))[:8]
        raise RuntimeError(f"the program's parameters are not the "
                           f"configuration's: {diff}")
    weights = seeds.make_weights(seed, specs, device)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(weights[n])


def program_record(trainer, feed, tr):
    """The three checked steps through the window's own call and feed:
    their losses, the first gradient's leaf norms (the first moment after
    one step over 1 - beta1) and each leaf's change over the three."""
    opt = trainer.optimizer
    p0 = {n: p.detach().clone() for n, p in opt.params.items()}
    losses, grad = [], None
    for k in range(CHECKED_STEPS):
        stats = trainer.train_step(next(feed), tr["lr"], tr["wd"])
        losses.append(float(stats["loss"]))
        if k == 0:
            b1 = opt.betas[0]
            grad = {n: v / (1 - b1)
                    for n, v in compare.leaf_norms(opt.mu).items()}
    delta = {n: (p.detach() - p0[n]).cpu() for n, p in opt.params.items()}
    return {"losses": losses, "grad": grad, "delta": delta}


def _steps(trainer, feed, tr, spans, world, flag_group, seconds, device):
    """Steps until ``seconds`` have passed on rank 0's clock; returns the
    count and (t0, t1) around them, t1 after a synchronize."""
    import torch.distributed as dist

    n = 0
    t0 = time.perf_counter()
    while True:
        with spans.span("vtbench.prefetch_next"):
            batch = next(feed)
        with spans.span("vtbench.train_step"):
            trainer.train_step(batch, tr["lr"], tr["wd"])
        n += 1
        stop = time.perf_counter() - t0 >= seconds
        if world > 1:
            flag = torch.tensor([int(stop)])
            dist.broadcast(flag, 0, group=flag_group)
            stop = bool(flag.item())
        if stop:
            break
    devices.sync(device)
    return n, t0, time.perf_counter()


def rank_main(rank, world, port, root, cell_name, args, started, queue,
              prepare=None):
    """One rank's run; rank 0 returns the ``harness.Run``, the others put
    their readings on ``queue``. ``prepare`` (an importable function, for
    rehearsals on the CPU) runs first in every rank's process."""
    from vtbench import registry

    if prepare is not None:
        prepare()
    cell = registry.cell(root, cell_name)
    cfg, tr = cell.config, cell.traffic
    device = devices.card(rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = flag_group = None
    if world > 1:
        import torch.distributed as dist

        from videotransformer_tpu_torch.parallel import mesh as _mesh

        os.environ["LOCAL_RANK"] = str(rank)
        _mesh.init_distributed(init_method=f"tcp://localhost:{port}",
                               rank=rank, world_size=world,
                               device=device.type)
        mesh = _mesh.create_mesh(device=device)
        flag_group = dist.new_group(backend="gloo")
    from videotransformer_tpu_torch.data.pipeline import device_prefetch
    from videotransformer_tpu_torch.training.trainer import (
        VideoTransformerTrainer)

    if device.type == "cuda":
        prebuild_kernels(KERNELS)
    trainer = VideoTransformerTrainer(trainer_configs(cell, args.seed),
                                      device, mesh=mesh)
    load_weights(trainer, cell, args.seed, device)
    pool = host_pool(cell, args.seed, rank, device)
    feed = device_prefetch(itertools.cycle(pool), device)
    prog = program_record(trainer, feed, tr)
    for _ in range(tr["warmup_steps"]):
        trainer.train_step(next(feed), tr["lr"], tr["wd"])
    devices.quiesce(device)
    if world > 1:
        _mesh.barrier(mesh)
    setup_s = time.perf_counter() - started
    spans = Spans(enabled=bool(args.trace))
    steps, t0, t1 = _steps(trainer, feed, tr, spans, world, flag_group,
                           args.seconds, device)
    if world > 1:
        _mesh.barrier(mesh)
        t1 = time.perf_counter()
    clips = steps * tr["clips_per_step"] * world
    print(f"vtbench: {steps} steps, {clips / (t1 - t0):.4f} clips/s in the "
          f"window", file=sys.stderr, flush=True)
    trace = None
    if args.trace:
        issue = sorted(1e3 * d for d in spans.durations("vtbench.train_step"))
        if issue:
            q = [issue[int(f * (len(issue) - 1))] for f in (0, .25, .5, .75,
                                                             1)]
            print("vtbench: train_step issue ms min/q1/median/q3/max "
                  + " ".join(f"{v:.1f}" for v in q), file=sys.stderr,
                  flush=True)
        devices.quiesce(device)
        marks = Spans(enabled=True, annotate=True)
        with tracing.window(device) as held:
            for _ in range(tr["trace_steps"]):
                with marks.span("vtbench.prefetch_next"):
                    batch = next(feed)
                with marks.span("vtbench.train_step"):
                    trainer.train_step(batch, tr["lr"], tr["wd"])
        trace = held["trace"]
    peak = devices.peak_bytes(device)
    b1 = trainer.optimizer.betas[0]
    del trainer, feed, pool
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if world > 1:
        _mesh.barrier(mesh)
        dist.destroy_process_group()
    mine = {"peak": peak, "busy_s": None if trace is None else trace.busy_s(),
            "window_s": None if trace is None else trace.window_s,
            "forbidden": harness.forbidden_modules()}
    if rank != 0:
        queue.put(mine)
        return None
    others = [queue.get(timeout=600) for _ in range(world - 1)]
    run = harness.Run(cell=cell, traced=bool(args.trace), setup_s=setup_s,
                      chips=world)
    run.attempted = steps
    run.end_to_end[tr["rate_metric"]] = clips / (t1 - t0)
    run.peak_bytes = max([peak] + [o["peak"] for o in others])
    run.forbidden = sorted({m for o in others for m in o["forbidden"]})
    run.spans = spans
    if trace is not None:
        run.trace = trace
        # each card's busy seconds within its own traced window (the ranks
        # start their profilers apart), both averaged over the cards
        cards = [mine] + others
        run.busy_s = sum(c["busy_s"] for c in cards) / len(cards)
        run.window_s = sum(c["window_s"] for c in cards) / len(cards)
        run.breakdown = tracing.breakdown(trace)
        run.work = {"steps": tr["trace_steps"],
                    "clips_per_card": tr["trace_steps"] * tr["clips_per_step"],
                    "backward": True}
    ref = reference_record(cell, args.seed, device, precision.Exact(), world,
                           betas=(b1, 0.999))
    numbers = compare.training_numbers(prog, ref)
    run.checks, run.correct = compare.judge(
        numbers, compare.limits(root, cell.name))
    return run


# ------------------------------------------------------------ the reference

def reference_record(cell, seed, device, ops, world, betas=(0.9, 0.999),
                     fault=None):
    """The reference following the three checked steps from the same
    weights, batches and draws, in float32 (``ops``: ``precision.Exact``,
    or the control): the record ``program_record`` makes. ``fault``
    plants a fault of the data-parallel program in the reference put in
    its place: "half", each rank's first half of its rows alone (the mean
    over them, the draws made for the smaller batch, as the program would
    make them); "no_exchange", rank 0's step on its own share of the
    gradient, never summed with the other ranks'."""
    cfg, tr, ref = cell.config, cell.traffic, cell.model.reference
    specs = ref.param_specs(cfg)
    params = {n: t.clone().requires_grad_()
              for n, t in seeds.make_weights(seed, specs, device).items()}
    p0 = {n: p.detach().clone() for n, p in params.items()}
    opt = optim.AdamW(params, betas=betas)
    losses, grad = [], None
    gseed = step_seed(seed)
    with precision.no_tf32():
        for step in range(CHECKED_STEPS):
            batch = global_batch(cell, seed, step % tr["pool_batches"], world,
                                 device)
            total = batch["raw_video"].shape[0]
            if fault == "half":
                n = tr["clips_per_step"]
                keep = torch.cat([torch.arange(r * n, r * n + n // 2)
                                  for r in range(world)]).to(device)
                batch = {k: v[keep] for k, v in batch.items()}
                total = keep.numel()
            g = torch.Generator(device=device).manual_seed(gseed + step + 7919)
            draws = ref.train_draws(g, cfg, batch, device)
            if fault == "no_exchange":
                total = tr["clips_per_step"]
            loss = 0.0
            for lo in range(0, total, tr["reference_chunk"]):
                hi = min(total, lo + tr["reference_chunk"])
                part = ref.train_loss(params, batch, draws, lo, hi, cfg, ops)
                part.backward()
                loss += float(part.detach())
                del part
            grads = {n: p.grad for n, p in params.items()}
            if step == 0:
                grad = compare.leaf_norms(grads)
                g1 = {n: g.detach().clone() for n, g in grads.items()}
            opt.step(grads, tr["lr"], tr["wd"])
            for p in params.values():
                p.grad = None
            losses.append(loss)
    delta = {n: p.detach() - p0[n] for n, p in params.items()}
    return {"losses": losses, "grad": grad, "g1": g1, "delta": delta}


# ------------------------------------------------------------ entry

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(cell, args, started, prepare=None):
    world = cell.chips
    if world == 1:
        return rank_main(0, 1, None, cell.root, cell.name, args, started,
                         None, prepare)
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=rank_main,
                         args=(r, world, port, cell.root, cell.name, args,
                               started, queue, prepare))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        return rank_main(0, world, port, cell.root, cell.name, args,
                         started, queue, prepare)
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
                p.join()
