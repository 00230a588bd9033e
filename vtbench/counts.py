"""The yardstick's frozen counts: the H100's peaks and the operations and
bytes of each hand-written kernel call (B1-B6 and MViT's pools) at its
shape. A model's forward FLOPs and the calls one step of it makes are its
adapter's (``vtbench/models/<model>.py``), built from these.

Conventions (the usual roofline model): a call's least time is
the larger of its operations over the bf16 dense peak and its bytes over
the HBM bandwidth; each input byte is counted read once and each output
byte written once, in bf16 (2 bytes), whatever the kernel reads again. Only
the products are counted as operations (2 per multiply-add); LayerNorm,
softmax, GELU and the bias adds are left out, so the counts are lower
bounds and a share of the roofline cannot pass 100% unless the time leaves
out part of the work. Attention's backward counts the four products it
needs (dV, dP, dQ, dK) and not the recomputed scores.

Sources: B1/B3 are ``fused_mhsa.fused_prenorm_mhsa`` of the port, B2/B4
``fused_ffn.fused_prenorm_ffn``, B5/B6 ``flash_attention``, and the pools
``kernels/mvit_pool.py::pool_qkv`` (the count is a copy of
``chip_smoke.py::pool_bytes``).
"""

import math

PEAK_BF16_FLOPS = 989e12  # one H100 SXM, dense bf16 (NVIDIA's data sheet)
PEAK_HBM_BYTES = 3.35e12  # one H100 SXM, HBM3
BF16 = 2


def bound_s(flops, nbytes):
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


# ------------------------------------------------------------ the kernels

def b1(seqs, L, D, Da=None, heads=12):
    """B1, fused prenorm MHSA forward over ``seqs`` sequences of ``L``
    tokens, width D, attention width Da: (flops, bytes). LayerNorm + qkv
    (D -> 3Da) + attention + proj (Da -> D); reads x and the weights,
    writes the output."""
    Da = Da or D
    rows = seqs * L
    hd = Da // heads
    flops = (2 * rows * D * 3 * Da + 4 * seqs * heads * L * L * hd
             + 2 * rows * Da * D)
    nbytes = BF16 * (2 * rows * D + 4 * Da * D + 4 * Da + 2 * D)
    return flops, nbytes


def b2(rows, D, hidden):
    """B2, fused prenorm FFN forward: fc1 (D -> hidden), GELU, fc2."""
    flops = 4 * rows * D * hidden
    nbytes = BF16 * (2 * rows * D + 2 * D * hidden + hidden + 3 * D)
    return flops, nbytes


def b3(seqs, L, D, Da=None, heads=12):
    """B3, B1's whole backward: dproj (two products), attention backward
    (four), dqkv's two products; reads x, the saved qkv and attention
    output, the output gradient and the weights; writes dx and the weight
    gradients."""
    Da = Da or D
    rows = seqs * L
    hd = Da // heads
    flops = (4 * rows * Da * D + 8 * seqs * heads * L * L * hd
             + 4 * rows * 3 * Da * D)
    nbytes = BF16 * (rows * (2 * D + 4 * Da + D) + 2 * (4 * Da * D)
                     + 4 * Da + 2 * D)
    return flops, nbytes


def b4(rows, D, hidden):
    """B4, B2's backward: four products (dW2, dh, dW1, dx); reads x, the
    saved hidden pre-activation, the output gradient and the weights;
    writes dx and the weight gradients."""
    flops = 8 * rows * D * hidden
    nbytes = BF16 * (rows * (3 * D + hidden) + 4 * D * hidden + hidden
                     + 3 * D)
    return flops, nbytes


def b5(batch, heads, Lq, Lk, hd):
    """B5, flash attention forward on (batch, heads, L, hd)."""
    flops = 4 * batch * heads * Lq * Lk * hd
    nbytes = BF16 * batch * heads * hd * (2 * Lq + 2 * Lk)
    return flops, nbytes


def b6(batch, heads, Lq, Lk, hd):
    """B6, flash attention backward: dV, dP, dQ, dK."""
    flops = 8 * batch * heads * Lq * Lk * hd
    nbytes = BF16 * batch * heads * hd * (4 * Lq + 4 * Lk)
    return flops, nbytes


def _touched(n, k, s):
    """Positions of a length-n axis that a pool's windows read (padding
    k // 2)."""
    out = (n + 2 * (k // 2) - k) // s + 1
    return len({o * s - k // 2 + i for o in range(out) for i in range(k)}
               & set(range(n)))


def _out_grid(thw, kernel, stride):
    """(T', H', W') of a pool over ``thw`` with padding k // 2."""
    return tuple((n + 2 * (k // 2) - k) // s + 1
                 for n, k, s in zip(thw, kernel, stride))


def mvit_pool(clips, thw, C, geometry, backward=False):
    """One call of MViT's depthwise pools on a block's fused qkv rows
    (clips, T·H·W, 3C): ``geometry`` holds q's, k's and v's (kernel,
    stride), or None for a slice without a pool. Forward: each pooled
    slice's input positions its windows read and its outputs, and a
    multiply-add per kernel tap an output. Backward: the whole d_qkv
    written, a slice without a pool its gradient read, each pooled slice
    its input positions and output gradients read; the input gradient and
    the weight gradient each a multiply-add per tap an output."""
    rows = clips * math.prod(thw)
    flops, nbytes = 0, BF16 * rows * 3 * C if backward else 0
    for g in geometry:
        if g is None:
            nbytes += BF16 * rows * C if backward else 0
            continue
        kernel, stride = g
        read = math.prod(_touched(n, k, s)
                         for n, k, s in zip(thw, kernel, stride))
        out = math.prod(_out_grid(thw, kernel, stride))
        nbytes += BF16 * clips * C * (read + out)
        flops += (4 if backward else 2) * math.prod(kernel) * clips * C * out
    return flops, nbytes


def total_bound_s(calls):
    """Least time of a list of (flops, bytes) calls."""
    return sum(bound_s(f, b) for f, b in calls)
