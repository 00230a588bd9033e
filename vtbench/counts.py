"""The yardstick's frozen counts: the H100's peaks, the operations and
bytes of each hand-written kernel call (B1-B6) at its shape, and the model
FLOPs of a forward of each configuration.

Conventions (the usual roofline model): a call's least time is
the larger of its operations over the bf16 dense peak and its bytes over
the HBM bandwidth; each input byte is counted read once and each output
byte written once, in bf16 (2 bytes), whatever the kernel reads again. Only
the products are counted as operations (2 per multiply-add); LayerNorm,
softmax, GELU and the bias adds are left out, so the counts are lower
bounds and a share of the roofline cannot pass 100% unless the time leaves
out part of the work. Attention's backward counts the four products it
needs (dV, dP, dQ, dK) and not the recomputed scores.

Sources: the kernels' calls are those of ``ops/blocks.py`` and
``models/mvit.py`` (B1/B3: ``fused_mhsa.fused_prenorm_mhsa``; B2/B4:
``fused_ffn.fused_prenorm_ffn``; B5/B6: ``flash_attention``), and the
shapes those modules give them; TimeSformer's forward count is a copy of
``benchmarks/run_all.py::timesformer_fwd_flops`` of the port, with the
head added; MViT's is worked out here from ``models/mvit.py`` and
``models/maskfeat.py``.
"""

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


def total_bound_s(calls):
    """Least time of a list of (flops, bytes) calls."""
    return sum(bound_s(f, b) for f, b in calls)


# ------------------------------------------------------------ TimeSformer

def timesformer_geometry(cfg):
    img, ps = cfg["img_size"], cfg["patch_size"]
    return dict(T=cfg["num_frames"], P=(img // ps) ** 2, D=cfg["embed_dims"],
                H=cfg["num_heads"], layers=cfg["num_transformer_layers"],
                hidden=cfg["embed_dims"] * cfg["mlp_ratio"],
                pix=ps * ps * cfg["in_channels"], classes=cfg["num_class"])


def timesformer_fwd_flops(cfg, views):
    """Model FLOPs of TimeSformer divided space-time over ``views`` clips
    (benchmarks/run_all.py::timesformer_fwd_flops of the port, with the
    classification head)."""
    g = timesformer_geometry(cfg)
    T, P, D, H = g["T"], g["P"], g["D"], g["H"]
    B, hd = views, D // H
    patch = 2 * B * T * P * g["pix"] * D
    r_t, r_s, r_f = B * P * T, B * T * (P + 1), B * (P * T + 1)
    temporal = (2 * r_t * D * 3 * D + 4 * B * P * H * T * T * hd
                + 2 * 2 * r_t * D * D)
    spatial = (2 * r_s * D * 3 * D + 4 * B * T * H * (P + 1) ** 2 * hd
               + 2 * r_s * D * D)
    ffn = 2 * r_f * D * g["hidden"] * 2
    return patch + g["layers"] * (temporal + spatial + ffn) + \
        2 * B * D * g["classes"]


def timesformer_kernel_calls(cfg, views, backward):
    """The (flops, bytes) of every B1-B4 call of one forward (and with
    ``backward`` its backward) over ``views`` clips: per layer B1 on the
    temporal rows (views·P sequences of T) and on the spatial rows
    (views·T sequences of 1 + P), B2 on all views·(P·T + 1) tokens."""
    g = timesformer_geometry(cfg)
    T, P, D, H = g["T"], g["P"], g["D"], g["H"]
    per_layer = [b1(views * P, T, D, heads=H),
                 b1(views * T, P + 1, D, heads=H),
                 b2(views * (P * T + 1), D, g["hidden"])]
    if backward:
        per_layer += [b3(views * P, T, D, heads=H),
                      b3(views * T, P + 1, D, heads=H),
                      b4(views * (P * T + 1), D, g["hidden"])]
    return per_layer * g["layers"]


# ------------------------------------------------------------ MViT-B

def _round_width(width, multiplier, min_width=1, divisor=1):
    """pytorchvideo's round_width (models/mvit.py of the port)."""
    if not multiplier:
        return width
    width *= multiplier
    min_width = min_width or divisor
    out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if out < 0.9 * width:
        out += divisor
    return int(out)


def mvit_blocks(cfg):
    """MViT-B's block schedule (``build_mvit_block_configs`` of the port,
    for the q-pool stages and adaptive kv stride of the configuration):
    one dict per block with dim, dim_out, heads, stride_q, stride_kv, and
    the (T, H, W) of its input tokens."""
    depth = cfg["depth"]
    dim_mul = [1.0] * (depth + 1)
    head_mul = [1.0] * (depth + 1)
    for i, m in cfg["embed_dim_mul"]:
        dim_mul[i] = m
    for i, m in cfg["atten_head_mul"]:
        head_mul[i] = m
    stride_q = [None] * depth
    for entry in cfg["pool_q_stride_size"]:
        stride_q[entry[0]] = list(entry[1:])
    kv = list(cfg["pool_kv_stride_adaptive"])
    stride_kv = []
    for i in range(depth):
        if stride_q[i]:
            kv = [max(kv[d] // stride_q[i][d], 1) for d in range(3)]
        stride_kv.append(list(kv))
    st = cfg["conv_patch_embed_stride"]
    thw = [cfg["num_frames"] // st[0], cfg["img_size"] // st[1],
           cfg["img_size"] // st[2]]
    heads, dim = cfg["num_heads"], cfg["patch_embed_dim"]
    blocks = []
    for i in range(depth):
        heads = _round_width(heads, head_mul[i], min_width=1, divisor=1)
        dim = _round_width(dim, dim_mul[i], divisor=heads)
        dim_out = _round_width(dim, dim_mul[i + 1],
                               divisor=_round_width(heads, head_mul[i + 1]))
        sq = stride_q[i] or [1, 1, 1]
        blocks.append(dict(dim=dim, dim_out=dim_out, heads=heads,
                           stride_q=sq, stride_kv=stride_kv[i],
                           thw=tuple(thw)))
        thw = _pooled(thw, sq)
    return blocks


def _pooled(thw, stride):
    # Conv3d with kernel 3, padding 1: ceil(n / s) for stride s
    return [(n - 1) // s + 1 for n, s in zip(thw, stride)]


def mvit_fwd_flops(cfg, clips):
    """Model FLOPs of MaskFeat's MViT-B forward over ``clips`` clips: the
    patch embed, every block's qkv, pools (depthwise 3³), attention
    (queries and the cls row against the pooled keys and the cls key),
    proj, MLP and skip proj, and decoder_pred."""
    k3 = 27
    st = cfg["conv_patch_embed_stride"]
    kt, kh, kw = cfg["conv_patch_embed_kernel"]
    thw0 = [cfg["num_frames"] // st[0], cfg["img_size"] // st[1],
            cfg["img_size"] // st[2]]
    L0 = thw0[0] * thw0[1] * thw0[2]
    total = 2 * L0 * 3 * kt * kh * kw * cfg["patch_embed_dim"]
    blocks = mvit_blocks(cfg)
    for blk in blocks:
        d, do, h = blk["dim"], blk["dim_out"], blk["heads"]
        L = blk["thw"][0] * blk["thw"][1] * blk["thw"][2]
        q_thw = _pooled(blk["thw"], blk["stride_q"])
        kv_thw = _pooled(blk["thw"], blk["stride_kv"])
        Lq = q_thw[0] * q_thw[1] * q_thw[2]
        Lk = kv_thw[0] * kv_thw[1] * kv_thw[2]
        total += 2 * (L + 1) * d * 3 * d           # qkv
        total += 2 * k3 * d * (Lq + 2 * Lk)        # the three pools
        total += 4 * (Lq + 1) * (Lk + 1) * d       # attention, all heads
        total += 2 * (Lq + 1) * d * d              # proj
        hidden = int(d * cfg["mlp_ratio"])
        total += 2 * (Lq + 1) * (d * hidden + hidden * do)
        if d != do:
            total += 2 * (Lq + 1) * d * do         # skip proj
    last = blocks[-1]
    q_thw = _pooled(last["thw"], last["stride_q"])
    Lf = q_thw[0] * q_thw[1] * q_thw[2]
    total += 2 * (Lf + 1) * last["dim_out"] * cfg["feature_dim"]
    return clips * total


def mvit_kernel_calls(cfg, clips, backward):
    """The (flops, bytes) of every B2/B4/B5/B6 call of one MaskFeat
    forward (and backward) over ``clips`` clips: B5 (B6) on each block's
    pooled queries against the cls key and the pooled keys; B2 (B4) on the
    patch tokens of the blocks whose width does not change."""
    calls = []
    for blk in mvit_blocks(cfg):
        d, do, h = blk["dim"], blk["dim_out"], blk["heads"]
        q_thw = _pooled(blk["thw"], blk["stride_q"])
        kv_thw = _pooled(blk["thw"], blk["stride_kv"])
        Lq = q_thw[0] * q_thw[1] * q_thw[2]
        Lk = kv_thw[0] * kv_thw[1] * kv_thw[2] + 1
        calls.append(b5(clips, h, Lq, Lk, d // h))
        if backward:
            calls.append(b6(clips, h, Lq, Lk, d // h))
        if d == do:
            hidden = int(d * cfg["mlp_ratio"])
            calls.append(b2(clips * Lq, d, hidden))
            if backward:
                calls.append(b4(clips * Lq, d, hidden))
    return calls


# ------------------------------------------------------------ by model

def fwd_flops(cfg, clips):
    """Model FLOPs of one forward of the configuration's model over
    ``clips`` views."""
    if cfg["model"] == "timesformer":
        return timesformer_fwd_flops(cfg, clips)
    if cfg["model"] == "maskfeat_mvit":
        return mvit_fwd_flops(cfg, clips)
    raise ValueError(cfg["model"])


def kernel_calls(cfg, clips, backward):
    if cfg["model"] == "timesformer":
        return timesformer_kernel_calls(cfg, clips, backward)
    if cfg["model"] == "maskfeat_mvit":
        return mvit_kernel_calls(cfg, clips, backward)
    raise ValueError(cfg["model"])
