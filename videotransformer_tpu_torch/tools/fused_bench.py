"""Times the fused prenorm-MHSA forward (B1) and the fused prenorm-FFN
backward (B4) at the main paths' shapes, whole and stage by stage, beside
the bound and ``torch.matmul`` at each product's GEMM shape, and beside the
kernels of another checkout when one is given: both are built from their own
``csrc/`` and timed in turns (baseline, kernel, kernel, baseline) on one
card.

    python3 -m videotransformer_tpu_torch.tools.fused_bench [--baseline DIR]

DIR is the root of another checkout (its
``videotransformer_tpu_torch/csrc/fused_mhsa.cu`` and ``fused_ffn_bwd.cu``
are built into ``DIR/build/fused_bench``). Both builds are called through
the wrappers (``fused_mhsa._launch``, ``fused_ffn._launch_backward``); a
checkout from before the wgmma redesign takes other C arguments and gets a
shim. Prints for each shape: device ms of each build, its share of the
bound, the host µs to issue a call, then each build's stages (device ms per
call from ``torch.profiler``: LN, qkv, attention and proj for B1; LN, dh,
dW2, dW1, dxn, LN backward and the sums for B4) with ``torch.matmul``'s
device ms beside each product (a yardstick the port never calls), and the
card's name and power limit. Needs a CUDA card and nvcc.
"""

import argparse
import ctypes
import os

import numpy as np
import torch

from videotransformer_tpu_torch.kernels import _build, fused_ffn, fused_mhsa
from videotransformer_tpu_torch.tools.flash_bench import (
    bound, card_name, issue_us, timed_ms)

D, HEADS = 768, 12
# (label, (B, N, D), block_diag, calls a serving forward or a train step)
MHSA_SHAPES = (("serve dense", (192, 197, D), 0, 12),
               ("serve temporal", (4704, 8, D), 8, 12),
               ("train dense", (64, 197, D), 0, 12),
               ("train temporal", (1568, 8, D), 8, 12))
# (label, (rows, D), LayerNorm eps, calls a step)
FFN_SHAPES = (("TimeSformer train", (12552, D), 1e-5, 12),
              ("MViT D=192", (50176, 192), 1e-6, 1),
              ("MViT D=384", (12544, 384), 1e-6, 10),
              ("MViT D=768", (12544, 768), 1e-6, 2))
MHSA_PRODUCTS = ("qkv", "proj")
FFN_PRODUCTS = ("dh", "dW2", "dW1", "dxn")


def mhsa_bound(rows, L, d):
    """(ms, by) of one B1 call: the two projections and attention against x
    read and out written, the weights once."""
    return bound(8 * rows * d * d + 4 * rows * L * d,
                 2 * (2 * rows * d + 4 * d * d + 6 * d))


def ffn_bwd_bound(rows, d):
    """(ms, by) of one B4 call: four products against x, h_pre, g read, dx
    written, the weights read and their fp32 gradients written."""
    return bound(32 * rows * d * d,
                 2 * (7 * rows * d + 8 * d * d) + 4 * 8 * d * d)


class _OldMhsa:
    """A pre-redesign B1 library behind the new C arguments: it took a bf16
    xn scratch (rows, D) where the new one takes the LayerNorm statistics,
    had no attention variant argument, and sized shared memory from (L,
    hd)."""

    def __init__(self, lib):
        self.lib, self.xn = lib, None

    def vt_mhsa_attention_smem_bytes(self, L, hd, variant):
        return self.lib.vt_mhsa_attention_smem_bytes(L, hd)

    def vt_fused_prenorm_mhsa(self, *a):
        a = list(a)
        rows, d = a[11], a[12]
        if self.xn is None or self.xn.shape != (rows, d):
            self.xn = torch.empty((rows, d), dtype=torch.bfloat16,
                                  device="cuda")
        a[7] = _build.ptr(self.xn)
        del a[17]
        return self.lib.vt_fused_prenorm_mhsa(*a)


class _OldFfnBwd:
    """A pre-redesign B4 library behind the new C arguments: no row slices
    (its weight gradients were one product over all rows)."""

    def __init__(self, lib):
        self.lib = lib

    def vt_ffn_bwd_scratch_floats(self, rows, d, hidden, do, s2, s1):
        return self.lib.vt_ffn_bwd_scratch_floats(rows, d, hidden, do)

    def vt_fused_prenorm_ffn_bwd(self, *a):
        a = list(a)
        del a[23:27]
        return self.lib.vt_fused_prenorm_ffn_bwd(*a)


def checkout_libs(root):
    """(B1, B4) libraries built from the checkout at ``root`` into
    ``root/build/fused_bench``, for the wrappers' ``lib``."""
    csrc = os.path.join(root, "videotransformer_tpu_torch", "csrc")
    build_dir = os.path.join(root, "build", "fused_bench")
    if os.path.exists(os.path.join(csrc, "sm90_gemm.cuh")):
        return (_build.load("fused_mhsa", fused_mhsa._SIGNATURES, csrc,
                            build_dir),
                _build.load("fused_ffn_bwd", fused_ffn._BWD_SIGNATURES, csrc,
                            build_dir))
    ints = lambda n: [ctypes.c_int] * n
    mhsa = {"vt_fused_prenorm_mhsa": [ctypes.c_void_p] * 11 + ints(6)
            + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
            "vt_mhsa_attention_smem_bytes": ints(2)}
    ffn = {"vt_fused_prenorm_ffn_bwd": [ctypes.c_void_p] * 19 + ints(4)
           + [ctypes.c_float, ctypes.c_void_p],
           "vt_ffn_bwd_scratch_floats": ints(4)}
    return (_OldMhsa(_build.load("fused_mhsa", mhsa, csrc, build_dir)),
            _OldFfnBwd(_build.load("fused_ffn_bwd", ffn, csrc, build_dir)))


def _stage_name(name, products, counter):
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


def mhsa_case(rng, shape, block_diag):
    d = shape[-1]
    mk = lambda s, std, mean=0.0: torch.from_numpy(
        rng.standard_normal(s, dtype=np.float32) * std + mean).to(
            "cuda", torch.bfloat16)
    args = [mk(shape, 1.0), mk((d,), 0.1, 1.0), mk((d,), 0.1),
            mk((3 * d, d), 0.02), mk((3 * d,), 0.02), mk((d, d), 0.02),
            mk((d,), 0.02)]
    return args, (HEADS, (d // HEADS) ** -0.5, 1e-5, True, block_diag)


def ffn_case(rng, shape, eps):
    rows, d = shape
    mk = lambda s, std, mean=0.0: torch.from_numpy(
        rng.standard_normal(s, dtype=np.float32) * std + mean).to(
            "cuda", torch.bfloat16)
    x, g = mk(shape, 1.0), mk(shape, 1.0)
    w = [mk((d,), 0.1, 1.0), mk((d,), 0.1), mk((4 * d, d), 0.02),
         mk((4 * d,), 0.02), mk((d, 4 * d), 0.02), mk((d,), 0.02)]
    _, h_pre = fused_ffn._launch(x, *w, eps, True)
    return (g, x, h_pre, w[0], w[1], w[2], w[4]), (eps,)


def matmul_ms(pairs):
    """torch.matmul's device ms at each (a, b) GEMM shape (bf16 out)."""
    return [timed_ms(lambda a=a, b=b: torch.matmul(a, b)) for a, b in pairs]


def mhsa_products(args, rows, d):
    x = args[0].reshape(rows, d)
    return [(x, args[3].t()), (x, args[5].t())]


def ffn_products(args, rows, d):
    g, x, h_pre, _, _, w1, w2 = args
    return [(g, w2), (g.t(), h_pre), (h_pre.t(), x), (h_pre, w1)]


def compare(label, calls, bound_ms, products, pairs, totals, count):
    """Times each build's call in turns, prints the line and the stages."""
    order = ["baseline", "kernel", "kernel", "baseline"] \
        if "baseline" in calls else ["kernel", "kernel"]
    got = {}
    for name in order:
        got.setdefault(name, []).append(timed_ms(calls[name]))
    ms = {name: sum(t) / len(t) for name, t in got.items()}
    bms, by = bound_ms
    for name, t in ms.items():
        totals[(label.split()[0], name)] = totals.get(
            (label.split()[0], name), 0.0) + count * t
    print(f"{label}: " + ", ".join(
        f"{name} {t:.4f} ms ({bms / t:.1%} of the bound; issued in "
        f"{issue_us(calls[name]):.1f} us)" for name, t in ms.items())
        + f"; bound {bms:.4f} ms ({by}); x{count}", flush=True)
    yard = matmul_ms(pairs)
    print(f"  torch.matmul at the products' GEMM shapes: " + ", ".join(
        f"{p} {t:.4f}" for p, t in zip(products, yard)), flush=True)
    for name, fn in calls.items():
        print(f"  {name} stages (device ms a call): "
              f"{format_stages(stage_times(fn, products))}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="root of another checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("fused_bench needs a CUDA device; none is visible")
    card = card_name()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    libs = {"kernel": (None, None)}
    if args.baseline:
        libs["baseline"] = checkout_libs(os.path.abspath(args.baseline))
    rng = np.random.default_rng(0)
    totals = {}
    with torch.inference_mode():
        for label, shape, block_diag, count in MHSA_SHAPES:
            a, tail = mhsa_case(rng, shape, block_diag)
            rows = shape[0] * shape[1]
            calls = {name: (lambda m=m: fused_mhsa._launch(*a, *tail, lib=m))
                     for name, (m, _) in libs.items()}
            compare(f"B1 {label} {shape}", calls,
                    mhsa_bound(rows, block_diag or shape[1], D),
                    MHSA_PRODUCTS, mhsa_products(a, rows, D), totals, count)
            del a
        for label, shape, eps, count in FFN_SHAPES:
            a, tail = ffn_case(rng, shape, eps)
            calls = {name: (lambda f=f: fused_ffn._launch_backward(
                *a, *tail, lib=f)) for name, (_, f) in libs.items()}
            compare(f"B4 {label} {shape}", calls,
                    ffn_bwd_bound(*shape), FFN_PRODUCTS,
                    ffn_products(a, *shape), totals, count)
            del a
    print("summed over the calls of a forward or a step (B1: 12 serving + "
          "12 train calls a shape; B4: 12 TimeSformer, 13 MViT): " + ", ".join(
              f"{k} {n} {t:.4f}" for (k, n), t in totals.items()))
    print(f"card: {card}")


if __name__ == "__main__":
    main()
