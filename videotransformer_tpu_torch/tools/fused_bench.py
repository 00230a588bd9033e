"""Times the fused prenorm kernels at the main paths' shapes, whole and stage
by stage, beside the bound and ``torch.matmul`` at each product's GEMM
shape, and beside the kernels of another checkout when one is given: both
are built from their own ``csrc/`` and timed in turns (baseline, kernel,
kernel, baseline) on one card. The kernels: B1 (the MHSA forward), B2 (the
FFN forward), B3 (the MHSA backward, alone from do and as the whole call
with its projection products) and B4 (the FFN backward). B1 and B3 are
also timed at ViViT-B's joint space-time shape (8, 1569, 768), their long
attention variant, with ``scaled_dot_product_attention`` beside the long
attention stage. B3's whole call is also timed in its recompute mode (qkv
rebuilt from x, the wrapper's ``RECOMPUTE_QKV``) against the same call
from the saved qkv, in turns.

    python3 -m videotransformer_tpu_torch.tools.fused_bench [--baseline DIR]

DIR is the root of another checkout with B3's one-call backward or later;
its libraries are built into ``DIR/build/fused_bench``. Both builds are
called through the wrappers (``_launch``, ``_launch_backward``,
``_attn_bwd_launch``, each with ``lib``). A checkout whose libraries
report older entry points gets an adapter that drops the arguments added
since (``OlderLib``): version 2 (before the recompute mode) lacks B3's
b_qkv and recompute flag, and times only the saved mode; version 1
(``vt_mhsa_abi_version`` missing: before the long variant) also lacks the
long variant's arguments, and cannot run the long shape. Prints for each
shape: device ms of each build, its share of the bound, the host µs to
issue a call, then each build's
stages (device ms per call from ``torch.profiler``) with ``torch.matmul``'s
device ms beside each product (a yardstick the port never calls), B2's fc1
with and without its GELU epilogue, and the card's name and power limit.
Needs a CUDA card and nvcc.
"""

import argparse
import ctypes
import os

import numpy as np
import torch

from videotransformer_tpu_torch.kernels import _build, fused_ffn, fused_mhsa
from videotransformer_tpu_torch.kernels._plain import layer_norm
from videotransformer_tpu_torch.tools.flash_bench import (
    bound, card_name, issue_us, sdpa_times, timed_ms)

D, HEADS = 768, 12
# (label, (B, N, D), block_diag, calls a serving forward or a train step)
# the last: joint space-time attention at ViViT-B's 8 effective frames
# (1569 tokens, 8 clips), B1's and B3's long variant
MHSA_SHAPES = (("serve dense", (192, 197, D), 0, 12),
               ("serve temporal", (4704, 8, D), 8, 12),
               ("train dense", (64, 197, D), 0, 12),
               ("train temporal", (1568, 8, D), 8, 12),
               ("ViViT joint long", (8, 1569, D), 0, 12))
MHSA_BWD_SHAPES = MHSA_SHAPES[2:]
# (label, (rows, D), LayerNorm eps, calls a forward or a step)
FFN_FWD_SHAPES = (("serve", (37656, D), 1e-5, 12),
                  ("TimeSformer train", (12552, D), 1e-5, 12),
                  ("MViT D=192", (50176, 192), 1e-6, 1),
                  ("MViT D=384", (12544, 384), 1e-6, 10),
                  ("MViT D=768", (12544, 768), 1e-6, 2))
FFN_SHAPES = FFN_FWD_SHAPES[1:]
MHSA_PRODUCTS = ("qkv", "proj")
FFN_FWD_PRODUCTS = ("fc1", "fc2")
FFN_PRODUCTS = ("dh", "dW2", "dW1", "dxn")
MHSA_BWD_PRODUCTS = ("dW_proj", "do", "d_xn", "dW_qkv")


def mhsa_bound(rows, L, d):
    """(ms, by) of one B1 call: the two projections and attention against x
    read and out written, the weights once."""
    return bound(8 * rows * d * d + 4 * rows * L * d,
                 2 * (2 * rows * d + 4 * d * d + 6 * d))


def ffn_fwd_bound(rows, d):
    """(ms, by) of one B2 call (hidden 4d): two products against x read and
    out written, the weights once."""
    return bound(16 * rows * d * d, 2 * (2 * rows * d + 8 * d * d + 7 * d))


def mhsa_bwd_bound(rows, L, d, whole=True, da=None, recompute=False):
    """(ms, by) of one B3 call at Do = d and attention width Da = ``da`` (d
    by default): alone, the attention backward (five products a head) and
    d_xn against x, qkv and do read and dx and dqkv written; whole, also
    dw_proj, do and dw_qkv, against g, x, qkv and attn read, dx and the
    fp32 weight gradients written; ``recompute``, the whole call rebuilding
    qkv: 2·rows·d·3Da FLOPs more, and x's rows·d read in place of qkv's
    rows·3Da."""
    da = da or d
    if not whole:
        return bound(10 * rows * L * da + 6 * rows * d * da,
                     2 * (2 * rows * d + 7 * rows * da + 3 * d * da))
    extra = (6 * rows * d * da, 2 * (rows * d - 3 * rows * da)) \
        if recompute else (0, 0)
    return bound(10 * rows * L * da + 16 * rows * d * da + extra[0],
                 2 * (3 * rows * d + 4 * rows * da + 4 * d * da)
                 + 4 * (4 * d * da + 3 * da + 3 * d) + extra[1])


def ffn_bwd_bound(rows, d, hidden=None):
    """(ms, by) of one B4 call (hidden 4·d by default): four products
    against x, h_pre, g read, dx written, the weights read and their fp32
    gradients written."""
    h = hidden or 4 * d
    return bound(8 * rows * d * h,
                 2 * (3 * rows * d + rows * h + 2 * d * h) + 4 * 2 * d * h)


class MhsaBwd:
    """B3 through the wrappers, with another build's library or this one's
    (``lib`` None): ``alone`` from do, ``whole`` the backward call."""

    def __init__(self, lib=None):
        self.lib = lib

    def alone(self, *core):
        return fused_mhsa._attn_bwd_launch(*core, lib=self.lib)

    def whole(self, *args, b_qkv=None):
        return fused_mhsa._launch_backward(*args, b_qkv=b_qkv, lib=self.lib)


class OlderLib:
    """A B1 or B3 library of entry points of version ``abi`` (B3's
    ``vt_mhsa_abi_version``), called with this version's arguments: the
    adapter drops from each call the ones added since. Version 2 lacks
    the whole backward's b_qkv and recompute flag (it always reads the
    saved qkv); version 1 also the long variant's (the lse pointer; B3
    alone's attn; the heads, length and variant of B3's scratch size)."""

    DROPPED = {2: {"vt_fused_prenorm_mhsa_bwd": (8, 31)},
               1: {"vt_fused_prenorm_mhsa": (10,),
                   "vt_fused_prenorm_mhsa_bwd": (4, 8, 31),
                   "vt_mhsa_attn_bwd": (3, 4),
                   "vt_mhsa_bwd_scratch_floats": (6, 7, 8)}}
    ADDED = {"vt_mhsa_bwd_qkv": 3}  # entry points, by the version adding them

    def __init__(self, name, signatures, csrc, build_dir, abi):
        self.dropped = self.DROPPED[abi]
        old = {fn: [t for i, t in enumerate(args)
                    if i not in self.dropped.get(fn, ())]
               for fn, args in signatures.items()
               if self.ADDED.get(fn, 1) <= abi}
        self.lib = _build.load(name, old, csrc, build_dir)

    def __getattr__(self, fn):
        entry = getattr(self.lib, fn)
        drop = self.dropped.get(fn, ())
        return lambda *a: entry(*[x for i, x in enumerate(a) if i not in drop])


def _abi_version(name, csrc, build_dir):
    """The version of a checkout's B1 or B3 entry points
    (``vt_mhsa_abi_version``; 1 for a library without it) and the library,
    loaded without signatures."""
    lib = ctypes.CDLL(_build.build(name, build_dir, csrc))
    entry = getattr(lib, "vt_mhsa_abi_version", None)
    return (entry() if entry else 1), lib


def checkout_libs(root):
    """{B1, B2, B3, B4} of the checkout at ``root`` (built into
    ``root/build/fused_bench``), for the wrappers' ``lib``, and whether
    they have the long attention variant (entry points of version 2) and
    B3's recompute mode (version 3)."""
    csrc = os.path.join(root, "videotransformer_tpu_torch", "csrc")
    build_dir = os.path.join(root, "build", "fused_bench")
    if not os.path.exists(os.path.join(csrc, "sm90_gemm.cuh")):
        raise ValueError(f"{root}: not a checkout of the wgmma design")
    abi, bwd = _abi_version("fused_mhsa_bwd", csrc, build_dir)
    if not hasattr(bwd, "vt_mhsa_attn_bwd"):
        raise ValueError(f"{root}: its B3 has no one-call backward")
    load = lambda name, sigs: _build.load(name, sigs, csrc, build_dir)
    if abi < 3:  # before the recompute mode (and the long variant, < 2)
        load = lambda name, sigs: OlderLib(name, sigs, csrc, build_dir, abi)
    ffn_sigs = {"vt_fused_prenorm_ffn":
                fused_ffn._SIGNATURES["vt_fused_prenorm_ffn"]}
    return {"long": abi >= 2, "recompute": abi >= 3,
            "B1": load("fused_mhsa", fused_mhsa._SIGNATURES),
            "B2": _build.load("fused_ffn", ffn_sigs, csrc, build_dir),
            "B3": MhsaBwd(load("fused_mhsa_bwd", fused_mhsa._BWD_SIGNATURES)),
            "B4": _build.load("fused_ffn_bwd", fused_ffn._BWD_SIGNATURES,
                              csrc, build_dir)}


def _stage_name(name, products, counter):
    if "flash" in name:
        return _flash_stage(name)
    if "ln_stats" in name:
        return "LN statistics"
    if "layernorm_bwd" in name or "ln_bwd" in name:
        return "LN backward"
    if "layernorm" in name:
        return "LN (xn)"
    if "colsum" in name:
        return "sums"
    if "attention" in name:
        return "attention"
    if "elementwise" in name:
        return "weight casts"
    if "gemm" in name:
        counter[0] += 1
        return products[counter[0] - 1] if counter[0] <= len(products) \
            else "product"
    return name[:40]


def _flash_stage(name):
    """B1's and B3's long attention stage: B5's and B6's kernels."""
    for key, stage in (("flash_fwd", "attention (long)"),
                       ("flash_dq", "attention (long, dq pass)"),
                       ("flash_dkdv", "attention (long, dk/dv pass)"),
                       ("flash_sum", "attention (long, dk/dv sums)")):
        if key in name:
            return stage
    return name[:40]


def stage_times(fn, products, n=3):
    """[(stage, device ms per call)] of ``fn``'s kernels in launch order,
    from ``torch.profiler``: ``n`` traced calls, each in a session of its
    own (after one untraced session: the profiler's start-up), averaged
    over the calls that traced the most common number of kernels; each
    kernel named by its stage, products (the GEMM launches) in order from
    ``products``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA]
    fn()
    with profile(activities=acts):
        fn()
        torch.cuda.synchronize()
    calls = []
    for _ in range(n):
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        calls.append(sorted(
            (e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA),
            key=lambda e: e.time_range.start))
    lengths = [len(c) for c in calls]
    per_call = max(set(lengths), key=lengths.count)
    calls = [c for c in calls if len(c) == per_call]
    counter, stages = [0], []
    for i in range(per_call):
        ms = sum(c[i].time_range.end - c[i].time_range.start
                 for c in calls) / 1e3 / len(calls)
        stages.append((_stage_name(calls[0][i].name, products, counter), ms))
    return stages


def format_stages(stages):
    return ", ".join(f"{s} {ms:.4f}" for s, ms in stages)


def _maker(rng):
    return lambda s, std, mean=0.0: torch.from_numpy(
        rng.standard_normal(s, dtype=np.float32) * std + mean).to(
            "cuda", torch.bfloat16)


def mhsa_case(rng, shape, block_diag):
    d = shape[-1]
    mk = _maker(rng)
    args = [mk(shape, 1.0), mk((d,), 0.1, 1.0), mk((d,), 0.1),
            mk((3 * d, d), 0.02), mk((3 * d,), 0.02), mk((d, d), 0.02),
            mk((d,), 0.02)]
    return args, (HEADS, (d // HEADS) ** -0.5, 1e-5, True, block_diag)


def ffn_fwd_case(rng, shape):
    """x (rows, d) and the weights of a width-d FFN, hidden 4d."""
    rows, d = shape
    mk = _maker(rng)
    return [mk(shape, 1.0), mk((d,), 0.1, 1.0), mk((d,), 0.1),
            mk((4 * d, d), 0.02), mk((4 * d,), 0.02), mk((d, 4 * d), 0.02),
            mk((d,), 0.02)]


def ffn_case(rng, shape, eps):
    x, *w = ffn_fwd_case(rng, shape)
    g = _maker(rng)(shape, 1.0)
    _, h_pre = fused_ffn._launch(x, *w, eps, True)
    return (g, x, h_pre, w[0], w[1], w[2], w[4]), (eps,)


def mhsa_bwd_case(rng, shape, block_diag):
    """The arguments of B3's whole call, ``_launch_backward`` (the forward
    kernel's own qkv, attn and lse), its config, B3 alone's (do from g;
    attn and lse last, which its long variant reads) and b_qkv (the
    recompute mode's)."""
    a, cfg = mhsa_case(rng, shape, block_diag)
    x, ln_w, ln_b, w_qkv, b_qkv, w_proj, _ = a
    _, qkv, attn, lse = fused_mhsa._launch(*a, *cfg)
    g = _maker(rng)(shape, 1.0)
    d = shape[-1]
    do = (g.float().reshape(-1, d) @ w_proj.float()).to(torch.bfloat16)
    core = (x, qkv, do, g.reshape(-1, d), ln_w, w_qkv, *cfg[:3], block_diag,
            attn, lse)
    return ((g, x, qkv, attn, lse, ln_w, ln_b, w_qkv, w_proj), cfg, core,
            b_qkv)


def recompute_args(args):
    """B3's whole-call arguments with qkv None: the recompute mode."""
    return args[:2] + (None,) + args[3:]


def sdpa_long_ms(rng, shape):
    """scaled_dot_product_attention's device ms (forward, backward) on q, k,
    v of the long attention stage at x's ``shape`` (B, L, D): (1, B·H, L,
    D/H), the yardstick beside that stage (the port never calls it). Its
    backward runs through autograd, so inference mode is off here."""
    B, L, d = shape
    with torch.inference_mode(False):
        q, k, v, do = (_maker(rng)((1, B * HEADS, L, d // HEADS), 1.0)
                       for _ in range(4))
        fwd, bwd, *_ = sdpa_times(q, k, v, do, (d // HEADS) ** -0.5)
    return fwd, bwd


def matmul_ms(pairs):
    """torch.matmul's device ms at each (a, b) GEMM shape (bf16 out)."""
    return [timed_ms(lambda a=a, b=b: torch.matmul(a, b)) for a, b in pairs]


def mhsa_products(args, rows, d):
    x = args[0].reshape(rows, d)
    return [(x, args[3].t()), (x, args[5].t())]


def ffn_fwd_products(args, rows, d):
    x, w1, w2 = args[0], args[3], args[5]
    h = torch.empty((rows, w1.shape[0]), dtype=x.dtype, device=x.device)
    return [(x, w1.t()), (h, w2.t())]


def ffn_products(args, rows, d):
    g, x, h_pre, _, _, w1, w2 = args
    return [(g, w2), (g.t(), h_pre), (h_pre.t(), x), (h_pre, w1)]


def mhsa_bwd_products(args, rows, d):
    """dw_proj = gᵀ·attn, do = g·Wproj, d_xn = dqkv·Wqkv, dw_qkv =
    dqkvᵀ·xn (qkv and x stand in for dqkv and xn: the same shapes)."""
    g, x, qkv, attn, _, _, _, w_qkv, w_proj = args
    g2, x2 = g.reshape(rows, -1), x.reshape(rows, d)
    return [(g2.t(), attn), (g2, w_proj), (qkv, w_qkv), (qkv.t(), x2)]


def fc1_epilogue_ms(args, eps):
    """B2's fc1 alone at (x's rows, hidden): device ms with its bias + GELU
    epilogue and with the bias alone (csrc/fused_ffn.cu's
    ``vt_ffn_fc1_stage``)."""
    x, ln_w, ln_b, w1, b1 = args[:5]
    rows, d = x.shape
    lib = _build.load("fused_ffn", fused_ffn._SIGNATURES)
    xn = layer_norm(x, ln_w, ln_b, eps)
    h = torch.empty((rows, w1.shape[0]), dtype=x.dtype, device=x.device)
    P = _build.ptr

    def fc1(gelu):
        return lambda: _build.check_status("fc1", lib.vt_ffn_fc1_stage(
            P(xn), P(w1), P(b1), P(h), rows, d, w1.shape[0], gelu,
            _build.stream_handle()))

    return timed_ms(fc1(1)), timed_ms(fc1(0))


def compare(kind, label, calls, bound_ms, products, pairs, totals, count):
    """Times each build's call in turns, prints the line and the stages."""
    order = ["baseline", "kernel", "kernel", "baseline"] \
        if "baseline" in calls else ["kernel", "kernel"]
    got = {}
    for name in order:
        got.setdefault(name, []).append(timed_ms(calls[name]))
    ms = {name: sum(t) / len(t) for name, t in got.items()}
    bms, by = bound_ms
    key = f"{kind} {label.split()[0]}"
    for name, t in ms.items():
        totals[(key, name)] = totals.get((key, name), 0.0) + count * t
    print(f"{kind} {label}: " + ", ".join(
        f"{name} {t:.4f} ms ({bms / t:.1%} of the bound; issued in "
        f"{issue_us(calls[name]):.1f} us)" for name, t in ms.items())
        + f"; bound {bms:.4f} ms ({by}); x{count}", flush=True)
    yard = matmul_ms(pairs)
    print(f"  torch.matmul at the products' GEMM shapes: " + ", ".join(
        f"{p} {t:.4f}" for p, t in zip(products, yard)), flush=True)
    for name, fn in calls.items():
        print(f"  {name} stages (device ms a call): "
              f"{format_stages(stage_times(fn, products))}", flush=True)


def recompute_row(b3, build, label, shape, args, cfg, b_qkv, saved_bound,
                  bound_ms):
    """B3's whole call of one build with qkv rebuilt (the recompute mode)
    against the same call from the saved qkv, timed in turns (saved,
    recompute, recompute, saved), each beside its bound, and the bits of
    the two calls' gradients compared."""
    saved = lambda: b3.whole(*args, *cfg)
    rebuilt = lambda: b3.whole(*recompute_args(args), *cfg, b_qkv=b_qkv)
    same = all(torch.equal(p, q) for p, q in zip(saved(), rebuilt()))
    s1, r1, r2, s2 = (timed_ms(f) for f in (saved, rebuilt, rebuilt, saved))
    s_ms, r_ms = (s1 + s2) / 2, (r1 + r2) / 2
    print(f"B3 whole call, recompute mode ({build}) {label} {shape}: "
          f"{r_ms:.4f} ms ({bound_ms[0] / r_ms:.1%} of its bound "
          f"{bound_ms[0]:.4f} ms, {bound_ms[1]}) against {s_ms:.4f} ms from "
          f"the saved qkv ({saved_bound[0] / s_ms:.1%} of "
          f"{saved_bound[0]:.4f} ms); extra {r_ms - s_ms:.4f} ms against "
          f"{bound_ms[0] - saved_bound[0]:.4f} ms of bound; the same "
          f"gradients to the bit: {same}", flush=True)


def _libs_at(libs, L):
    """The builds that take sequences of L tokens: one from before the long
    attention variant takes none above 256."""
    return {n: lib for n, lib in libs.items()
            if L <= 256 or lib.get("long", True)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="root of another checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("fused_bench needs a CUDA device; none is visible")
    card = card_name()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    libs = {"kernel": {"B1": None, "B2": None, "B3": MhsaBwd(), "B4": None}}
    if args.baseline:
        libs["baseline"] = checkout_libs(os.path.abspath(args.baseline))
    rng = np.random.default_rng(0)
    totals = {}
    with torch.inference_mode():
        for label, shape, block_diag, count in MHSA_SHAPES:
            a, tail = mhsa_case(rng, shape, block_diag)
            rows = shape[0] * shape[1]
            calls = {n: (lambda m=lib["B1"]: fused_mhsa._launch(*a, *tail,
                                                                 lib=m))
                     for n, lib in _libs_at(libs, block_diag or shape[1])
                     .items()}
            compare("B1", f"{label} {shape}", calls,
                    mhsa_bound(rows, block_diag or shape[1], D),
                    MHSA_PRODUCTS, mhsa_products(a, rows, D), totals, count)
            if shape[1] > 256:
                print(f"  scaled_dot_product_attention forward on the long "
                      f"stage's q, k, v: {sdpa_long_ms(rng, shape)[0]:.4f} "
                      f"ms", flush=True)
            del a
        for label, shape, eps, count in FFN_FWD_SHAPES:
            a = ffn_fwd_case(rng, shape)
            calls = {n: (lambda m=lib["B2"]: fused_ffn._launch(
                *a, eps, False, lib=m)) for n, lib in libs.items()}
            compare("B2", f"{label} {shape}", calls, ffn_fwd_bound(*shape),
                    FFN_FWD_PRODUCTS, ffn_fwd_products(a, *shape), totals,
                    count)
            with_gelu, without = fc1_epilogue_ms(a, eps)
            print(f"  kernel fc1 with its bias + GELU epilogue {with_gelu:.4f} "
                  f"ms, with the bias alone {without:.4f} ms", flush=True)
            del a
        for label, shape, block_diag, count in MHSA_BWD_SHAPES:
            a, cfg, core, b_qkv = mhsa_bwd_case(rng, shape, block_diag)
            rows = shape[0] * shape[1]
            L = block_diag or shape[1]
            calls = {n: (lambda b=lib["B3"]: b.alone(*core))
                     for n, lib in _libs_at(libs, L).items()}
            compare("B3 alone", f"{label} {shape}", calls,
                    mhsa_bwd_bound(rows, L, D, whole=False), ("d_xn",),
                    mhsa_bwd_products(a, rows, D)[2:3], totals, count)
            calls = {n: (lambda b=lib["B3"]: b.whole(*a, *cfg))
                     for n, lib in _libs_at(libs, L).items()}
            compare("B3 whole call", f"{label} {shape}", calls,
                    mhsa_bwd_bound(rows, L, D), MHSA_BWD_PRODUCTS,
                    mhsa_bwd_products(a, rows, D), totals, count)
            for n, lib in _libs_at(libs, L).items():
                if n == "kernel" or lib.get("recompute"):
                    recompute_row(lib["B3"], n, label, shape, a, cfg, b_qkv,
                                  mhsa_bwd_bound(rows, L, D),
                                  mhsa_bwd_bound(rows, L, D, recompute=True))
            if L > 256:
                print(f"  scaled_dot_product_attention backward on the long "
                      f"stage's q, k, v: {sdpa_long_ms(rng, shape)[1]:.4f} "
                      f"ms", flush=True)
            del a, core
        for label, shape, eps, count in FFN_SHAPES:
            a, tail = ffn_case(rng, shape, eps)
            calls = {n: (lambda f=lib["B4"]: fused_ffn._launch_backward(
                *a, *tail, lib=f)) for n, lib in libs.items()}
            compare("B4", f"{label} {shape}", calls, ffn_bwd_bound(*shape),
                    FFN_PRODUCTS, ffn_products(a, *shape), totals, count)
            del a
    print("summed over the calls of a serving forward or a train or mim "
          "step (x the count on each line): "
          + ", ".join(f"{k} {n} {t:.4f}" for (k, n), t in totals.items()))
    print(f"card: {card}")


if __name__ == "__main__":
    main()
