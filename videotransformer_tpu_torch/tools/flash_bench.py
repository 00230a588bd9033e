"""Times the flash-attention kernels (B5 forward, B6 backward) at the calls of
one batch-8 MaskFeat step on MViT-B (head dim 96) and at the head-dim-64
long shapes (joint space-time attention and the 448² spatial rows, which
B1's and B3's long variant run too), beside
``scaled_dot_product_attention`` and the bound, and beside the kernels of
another checkout when one is given: both are built from their own ``csrc/``
and timed in turns (baseline, kernel, kernel, baseline) on one card.

    python3 -m videotransformer_tpu_torch.tools.flash_bench [--baseline DIR]
        [--variant DIR ...] [--sass]

DIR is the root of another checkout (its
``videotransformer_tpu_torch/csrc/flash_attention*.cu`` are built into
``DIR/build/flash_bench``). Each ``--variant`` is a copy of this
checkout's ``csrc/`` edited (as ``DIR/videotransformer_tpu_torch/csrc``),
built the same way and timed in the same turns (variants and baseline,
kernel, kernel, then the others again), to compare tile choices. Every
build is called through the wrappers
(``kernels/flash_attention._launch``, ``_launch_backward``). Prints one line
per shape and direction: device ms, TFLOP/s, share of the bound and host µs
to issue a call, for each build and for SDPA; the host time's parts at
PARTS_SHAPE; the totals of one mim step (each shape times its calls) and,
apart, of the hd-64 calls (each long shape times its 12 calls); and the
card's name and power limit. Needs a CUDA card and nvcc. ``--sass`` first
prints, for each build's hd-64 flash kernels, the count of each softmax
instruction in their machine code (``cuobjdump -sass``, from the CUDA
toolkit beside nvcc).
"""

import argparse
import collections
import os
import re
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from videotransformer_tpu_torch.kernels import _build, flash_attention

HD = 96
# (B·H, Nq, Nkv, calls) of the flash attention calls of one batch-8 mim step
FLASH_SHAPES = ((8, 25088, 393, 1), (16, 6272, 1569, 1), (16, 6272, 393, 1),
                (32, 1568, 1569, 1), (32, 1568, 393, 10), (64, 1568, 393, 2))
# the head-dim-64 long shapes, ((B·H, Nq, Nkv, calls), where), 12 calls
# each (one a layer): joint space-time attention of TimeSformer-B at 16
# frames (8 clips, 12 heads, 1 + 16·196 tokens: the JAX package's flash
# path at N > 2048); ViViT-B joint and TimeSformer-B joint at 8 frames, 8
# clips (1 + 8·196 tokens; B1's and B3's long attention stage at (8, 1569,
# 768)); TimeSformer-B's divided spatial rows served at 448², 8 clips x 3
# crops x 8 frames (1 + 28·28 tokens; B1's at (192, 785, 768))
JOINT_HD = 64
LONG_SHAPES = (
    ((96, 3137, 3137, 12), "TimeSformer-B joint at 16 frames"),
    ((96, 1569, 1569, 12), "ViViT-B joint, TimeSformer-B joint at 8 frames"),
    ((2304, 785, 785, 12), "TimeSformer-B divided spatial at 448²"))
# where the wrapper's host time is broken into its parts: the shape with the
# most calls a step
PARTS_SHAPE = (32, 1568, 393)
# the card's peaks (H100 SXM data sheet, dense): bf16 tensor cores, HBM
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
# ~10 ms of the card's clock: longer than the host takes to issue a timed run
SLEEP_CYCLES = 20_000_000


def timed_ms(fn, iters=20, warmup=3, queued=True):
    """Mean time of one call, from CUDA events over ``iters`` calls. Queued
    (a kernel's time), the calls wait behind a device-side sleep, so the
    events time the card running them back to back and not the host issuing
    them: a call of a few tens of microseconds takes about as long to issue.
    Not queued (a whole forward's time), the host's time counts where the
    card waits for it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def issue_us(fn, iters=50):
    """Host time to issue one call (no wait for the card), in microseconds,
    with the calls queued behind a device-side sleep."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def bound(flops, nbytes):
    """(ms, "operations" or "bytes"): the least time the card could take."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_bounds(bh, nq, nkv, hd):
    """((ms, by) of the forward, (ms, by) of the backward, forward FLOPs):
    4·Nq·Nkv·hd FLOPs against q, k, v read and o written; the backward's
    five products (2.5x) against q, k, v, o, do read and dq, dk, dv
    written."""
    flops = 4 * bh * nq * nkv * hd
    return (bound(flops, 2 * (2 * nq + 2 * nkv) * bh * hd),
            bound(2.5 * flops, 2 * (4 * nq + 6 * nkv) * bh * hd), flops)


def sdpa_times(q, k, v, do, scale):
    """``scaled_dot_product_attention`` on the same operands: (forward ms,
    backward ms, forward issue µs, backward issue µs). The backward's are
    those of its forward and backward through autograd less those of its
    forward with grad."""
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    plain = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
    fwd = lambda: F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
    both = lambda: torch.autograd.grad(fwd(), (qg, kg, vg), do)
    return (timed_ms(plain), timed_ms(both) - timed_ms(fwd), issue_us(plain),
            issue_us(both) - issue_us(fwd))


def checkout_libs(root):
    """(forward, backward) flash libraries built from the checkout at
    ``root`` into ``root/build/flash_bench``, for the wrappers' ``lib``. A
    checkout of PR 3's two-pass design has no ``vt_flash_bwd_row_floats``:
    its row array held delta alone, B·H·Nq floats."""
    fa = flash_attention
    csrc = os.path.join(root, "videotransformer_tpu_torch", "csrc")
    build_dir = os.path.join(root, "build", "flash_bench")
    bwd_sigs = {n: s for n, s in fa._BWD_SIGNATURES.items()
                if n != "vt_flash_bwd_row_floats"}
    fwd = _build.load("flash_attention", fa._SIGNATURES, csrc, build_dir)
    bwd = _build.load("flash_attention_bwd", bwd_sigs, csrc, build_dir)
    if not hasattr(bwd, "vt_flash_bwd_row_floats"):
        bwd.vt_flash_bwd_row_floats = lambda bh, nq: bh * nq
    return fwd, bwd


def issue_parts(q, k, v, do, scale):
    """Host µs to issue one B5 and one B6 call through the wrapper, beside
    its parts: the argument checks, the allocations, the ctypes pointers,
    and the C entry point alone (its tensor maps, shared-memory attribute
    and launches) on arguments made once."""
    fa, P = flash_attention, _build.ptr
    fwd_lib = _build.load("flash_attention", fa._SIGNATURES)
    bwd_lib = _build.load("flash_attention_bwd", fa._BWD_SIGNATURES)
    bh, nq, nkv, hd = q.shape[1], q.shape[2], k.shape[2], q.shape[3]
    f32 = lambda n: torch.empty(n, dtype=torch.float32, device=q.device)
    o, lse = fa._launch(q, k, v, scale)
    rows = f32(bwd_lib.vt_flash_bwd_row_floats(bh, nq))
    scratch = f32(bwd_lib.vt_flash_bwd_scratch_floats(bh, nq, nkv, hd))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    tail = [bh, nq, nkv, hd, float(scale), _build.stream_handle()]
    fwd_ops, bwd_ops = (q, k, v, o, lse), (q, k, v, o, lse, do, rows,
                                            scratch, dq, dk, dv)
    fwd_args = [P(t) for t in fwd_ops] + tail
    bwd_args = [P(t) for t in bwd_ops] + tail
    forward = {
        "wrapper": lambda: fa._launch(q, k, v, scale),
        "checks": lambda: (_build.check_operands("", q=q, k=k, v=v),
                           fa._check_shapes("", q, k, v, scale)),
        "allocations": lambda: (torch.empty_like(q), f32(q.shape[:3])),
        "pointers": lambda: ([P(t) for t in fwd_ops],
                             _build.stream_handle()),
        "C call": lambda: fwd_lib.vt_flash_attention_fwd(*fwd_args)}
    backward = {
        "wrapper": lambda: fa._launch_backward(q, k, v, o, lse, do, scale),
        "checks": lambda: (_build.check_operands("", q=q, k=k, v=v, o=o,
                                                 do=do),
                           fa._check_shapes("", q, k, v, scale)),
        "allocations": lambda: (
            f32(bwd_lib.vt_flash_bwd_row_floats(bh, nq)),
            f32(bwd_lib.vt_flash_bwd_scratch_floats(bh, nq, nkv, hd)),
            *(torch.empty_like(t) for t in (q, k, v))),
        "pointers": lambda: ([P(t) for t in bwd_ops],
                             _build.stream_handle()),
        "C call": lambda: bwd_lib.vt_flash_attention_bwd(*bwd_args)}
    parts = {"forward": forward, "backward": backward}
    return {what: {part: issue_us(fn) for part, fn in fns.items()}
            for what, fns in parts.items()}


# the softmax's instructions, counted in the kernels' machine code
SASS_OPS = ("MUFU.EX2", "FFMA", "FMUL", "FADD", "FMNMX", "F2FP", "SHFL",
            "HGMMA")


def sass_counts(so_path):
    """{kernel: {opcode: count}} of the hd-64 flash kernels (the names with
    ``ILi64E``: flash_fwd_kernel<64>, the backward's) in a built library,
    from ``cuobjdump -sass``; every opcode counted by its SASS_OPS prefix."""
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so_path], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if "ILi64E" in m.group(1) else None
            if name:
                counts[name] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                      line)
        if name and m:
            op = m.group(1)
            for prefix in SASS_OPS:
                if op == prefix or op.startswith(prefix + "."):
                    counts[name][prefix] += 1
    return counts


def print_sass(builds):
    """Prints sass_counts of each (label, build directory) pair's flash
    libraries."""
    for label, build_dir in builds:
        for lib in ("flash_attention", "flash_attention_bwd"):
            so = os.path.join(build_dir, f"lib{lib}.so")
            for kernel, c in sass_counts(so).items():
                print(f"sass {label} {kernel}: " + ", ".join(
                    f"{op} {c[op]}" for op in SASS_OPS), flush=True)


def card_name():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="root of another checkout")
    ap.add_argument("--variant", action="append", default=[],
                    help="root of a variant of this checkout's csrc/ "
                         "(named by its directory), timed in turns with "
                         "the baseline")
    ap.add_argument("--sass", action="store_true",
                    help="count the hd-64 kernels' softmax instructions")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("flash_bench needs a CUDA device; none is visible")
    card = card_name()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    fa = flash_attention
    libs = {"kernel": (None, None)}  # the wrappers' own builds
    if args.baseline:
        libs["baseline"] = checkout_libs(os.path.abspath(args.baseline))
    for root in args.variant:
        libs[os.path.basename(os.path.normpath(root))] = checkout_libs(
            os.path.abspath(root))
    if args.sass:
        for lib in ("flash_attention", "flash_attention_bwd"):
            _build.build(lib)
        builds = [("kernel", _build.BUILD_DIR)]
        if args.baseline:
            builds.append(("baseline", os.path.join(
                os.path.abspath(args.baseline), "build", "flash_bench")))
        print_sass(builds)
    names = (*libs, "sdpa")

    rng = np.random.default_rng(0)
    totals = {"mim step": {}, "hd 64": {}}
    cases = [(shape, HD, "mim step") for shape in FLASH_SHAPES] + [
        (shape, JOINT_HD, "hd 64") for shape, _ in LONG_SHAPES]
    for (bh, nq, nkv, count), hd, group in cases:
        scale = hd ** -0.5
        mk = lambda n: torch.from_numpy(rng.standard_normal(
            (1, bh, n, hd), dtype=np.float32)).to("cuda", torch.bfloat16)
        q, k, v, do = mk(nq), mk(nkv), mk(nkv), mk(nq)
        o, lse = fa._launch(q, k, v, scale)
        calls = {
            "forward": {name: (lambda f=f: fa._launch(q, k, v, scale, f))
                        for name, (f, _) in libs.items()},
            "backward": {name: (lambda b=b: fa._launch_backward(
                q, k, v, o, lse, do, scale, b)) for name, (_, b) in libs.items()}}
        ms, us = {}, {}
        for what, fns in calls.items():
            others = [name for name in fns if name != "kernel"]
            order = others + ["kernel", "kernel"] + others[::-1]
            got = {}
            for name in order:
                got.setdefault(name, []).append(timed_ms(fns[name]))
            for name, ts in got.items():
                ms[(what, name)] = sum(ts) / len(ts)
                us[(what, name)] = issue_us(fns[name])
        (ms[("forward", "sdpa")], ms[("backward", "sdpa")],
         us[("forward", "sdpa")], us[("backward", "sdpa")]) = sdpa_times(
             q, k, v, do, scale)
        fb, bb, flops = flash_bounds(bh, nq, nkv, hd)
        tot = totals[group]
        for what, (bms, by), f in (("forward", fb, flops),
                                   ("backward", bb, 2.5 * flops)):
            tot[(what, "bound")] = tot.get((what, "bound"), 0.0) + count * bms
            for name in names:
                t, host = ms[(what, name)], us[(what, name)] / 1e3
                for key, x in ((name, t), (f"{name} host-bound", max(t, host))):
                    tot[(what, key)] = tot.get((what, key), 0.0) + count * x
            print(f"{what} (B·H, Nq, Nkv, hd) = ({bh}, {nq}, {nkv}, {hd}) "
                  f"x{count}: " + ", ".join(
                      f"{name} {ms[(what, name)]:.4f} ms "
                      f"({f / ms[(what, name)] / 1e9:.1f} TFLOP/s, "
                      f"{bms / ms[(what, name)]:.1%} of the bound; issued in "
                      f"{us[(what, name)]:.1f} us)" for name in names)
                  + f"; bound {bms:.4f} ms ({by})", flush=True)
        if (bh, nq, nkv) == PARTS_SHAPE:
            for what, parts in issue_parts(q, k, v, do, scale).items():
                print(f"{what} at {PARTS_SHAPE}: host us to issue one call: "
                      + ", ".join(f"{p} {t:.1f}" for p, t in parts.items()),
                      flush=True)
        del q, k, v, do, o, lse
    for group, what_is in (
            ("mim step", "one step (each shape times its calls"),
            ("hd 64", "the hd-64 calls (each long shape times its 12 calls")):
        print(f"{group}: {what_is}; host-bound: each call max(device ms, "
              f"issue ms), as when called back to back on an idle card): "
              + ", ".join(f"{what} {key} {t:.4f}"
                          for (what, key), t in totals[group].items()))
    print(f"card: {card}")


if __name__ == "__main__":
    main()
