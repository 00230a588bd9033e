"""MaskFeat (Wei et al., arXiv:2112.09133) on MViT-B (Fan et al.,
arXiv:2104.11227) in the benchmark: its plain reference and its counts.

The counts are those of the masked-feature pretraining step the trainer
runs (``trainer.objective`` "mim"); any other objective raises. The
forward count is worked out from the port's ``models/mvit.py`` and
``models/maskfeat.py``; the kernel calls are those of ``models/mvit.py``
(B2/B4: ``fused_ffn.fused_prenorm_ffn``; B5/B6: ``flash_attention``; the
pools: ``kernels/mvit_pool.py::pool_qkv``, one call a block).
"""

from vtbench.counts import b2, b4, b5, b6, mvit_pool
from vtbench.reference import mvit as reference

COUNTED = "mim"


def schedule(cfg):
    """The reference's block schedule, for the objective counted only."""
    if cfg["trainer"]["objective"] != COUNTED:
        raise ValueError(f"MaskFeat counts know the {COUNTED} objective "
                         f"only, not {cfg['trainer']['objective']}")
    return reference.blocks(cfg)


def fwd_flops(cfg, clips):
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
    blocks = schedule(cfg)
    for blk in blocks:
        d, do, h = blk["dim"], blk["dim_out"], blk["heads"]
        L = blk["thw"][0] * blk["thw"][1] * blk["thw"][2]
        q_thw = reference.pooled(blk["thw"], blk["stride_q"])
        kv_thw = reference.pooled(blk["thw"], blk["stride_kv"])
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
    q_thw = reference.pooled(last["thw"], last["stride_q"])
    Lf = q_thw[0] * q_thw[1] * q_thw[2]
    total += 2 * (Lf + 1) * last["dim_out"] * cfg["feature_dim"]
    return clips * total


def pools(cfg):
    """(thw, C, geometry) of each block's pool call: the block's token
    grid and width, and q's, k's and v's (kernel, stride), q's None where
    the block does not stride its queries."""
    kernel = tuple(cfg["pool_kvq_kernel"])
    return [(blk["thw"], blk["dim"],
             ((kernel, tuple(blk["stride_q"])) if blk["pool_q"] else None,
              (kernel, tuple(blk["stride_kv"])),
              (kernel, tuple(blk["stride_kv"]))))
            for blk in schedule(cfg)]


def kernel_calls(cfg, clips, backward):
    """The (flops, bytes) of every hand-written kernel call of one MaskFeat
    forward (and backward) over ``clips`` clips: B5 (B6) on each block's
    pooled queries against the cls key and the pooled keys; B2 (B4) on the
    patch tokens of the blocks whose width does not change; then each
    block's pool call forward (and backward)."""
    calls = []
    for blk in schedule(cfg):
        d, do, h = blk["dim"], blk["dim_out"], blk["heads"]
        q_thw = reference.pooled(blk["thw"], blk["stride_q"])
        kv_thw = reference.pooled(blk["thw"], blk["stride_kv"])
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
    for thw, C, geometry in pools(cfg):
        calls.append(mvit_pool(clips, thw, C, geometry))
        if backward:
            calls.append(mvit_pool(clips, thw, C, geometry, backward=True))
    return calls
