"""MaskFeat on MViT-B, plain, and its train step.

Follows Wei et al. (arXiv:2112.09133) on Fan et al.'s MViT-B 16x4
(arXiv:2104.11227), as the port's ``models/maskfeat.py`` and
``models/mvit.py`` build it (pytorchvideo's layers as the original repo
configures them), under the port's parameter names:

- patch embed: Conv3d kernel (3, 7, 7), stride (2, 4, 4), padding
  (1, 3, 3); masked tokens mixed toward ``mask_token`` by the cube mask
  upsampled nearest by 4; separate spatial, temporal and cls position
  tables;
- each block: LayerNorm, fused qkv, Q, K and V each pooled by a depthwise
  Conv3d (kernel 3³, padding 1, one head-dim kernel tiled over the heads)
  and a per-head LayerNorm, the patch tokens and the cls token apart; the
  cls key and value joined in front; softmax attention of the pooled
  queries and of the cls query; proj; a MaxPool3d skip where Q is strided;
  then LayerNorm and the MLP (erf GELU), with a Linear proj on the
  residual where the width grows. All LayerNorms use eps 1e-6;
- final LayerNorm, ``decoder_pred`` to 216 = 2 frames x 108 HOG features
  a token, and the masked MSE over the cube-center frames only, divided
  by the masked count (plus 1e-5).

The step's only draws are the augment's (RandomResizedCrop scale
(0.5, 1) and the flip); the schedule has no DropPath.
"""

import torch
import torch.nn.functional as F

from vtbench.reference import augment, hog

EPS = 1e-6


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


def blocks(cfg):
    """MViT-B's block schedule (``build_mvit_block_configs`` of the port,
    for the q-pool stages and adaptive kv stride of the configuration):
    one dict per block with dim, dim_out, heads, stride_q, stride_kv,
    whether Q is pooled (``pool_q``), and the (T, H, W) of its input
    tokens."""
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
    out = []
    for i in range(depth):
        heads = _round_width(heads, head_mul[i], min_width=1, divisor=1)
        dim = _round_width(dim, dim_mul[i], divisor=heads)
        dim_out = _round_width(dim, dim_mul[i + 1],
                               divisor=_round_width(heads, head_mul[i + 1]))
        sq = stride_q[i] or [1, 1, 1]
        out.append(dict(dim=dim, dim_out=dim_out, heads=heads, stride_q=sq,
                        stride_kv=stride_kv[i], pool_q=bool(stride_q[i]),
                        thw=tuple(thw)))
        thw = pooled(thw, sq)
    return out


def pooled(thw, stride):
    # Conv3d with kernel 3, padding 1: ceil(n / s) for stride s
    return [(n - 1) // s + 1 for n, s in zip(thw, stride)]


def param_specs(cfg):
    """{name: (shape, mean, std)} under the port's names (``model.``)."""
    k = list(cfg["conv_patch_embed_kernel"])
    C0 = cfg["patch_embed_dim"]
    st = cfg["conv_patch_embed_stride"]
    T = cfg["num_frames"] // st[0]
    HW = (cfg["img_size"] // st[1]) * (cfg["img_size"] // st[2])
    m = "model.mvit."
    shapes = {"model.patch_embed.patch_model.weight": (C0, 3, *k),
              "model.patch_embed.patch_model.bias": (C0,),
              "model.mask_token": (1, 1, C0),
              m + "cls_positional_encoding.pos_embed_spatial": (1, HW, C0),
              m + "cls_positional_encoding.pos_embed_temporal": (1, T, C0),
              m + "cls_positional_encoding.cls_token": (1, 1, C0),
              m + "cls_positional_encoding.pos_embed_class": (1, 1, C0)}
    bl = blocks(cfg)
    for i, b in enumerate(bl):
        d, do, hd = b["dim"], b["dim_out"], b["dim"] // b["heads"]
        hid = int(d * cfg["mlp_ratio"])
        p = f"{m}blocks.{i}."
        shapes.update({p + "norm1.weight": (d,), p + "norm1.bias": (d,),
                       p + "attn.qkv.weight": (3 * d, d),
                       p + "attn.qkv.bias": (3 * d,),
                       p + "attn.proj.weight": (d, d),
                       p + "attn.proj.bias": (d,),
                       p + "norm2.weight": (d,), p + "norm2.bias": (d,),
                       p + "mlp.fc1.weight": (hid, d),
                       p + "mlp.fc1.bias": (hid,),
                       p + "mlp.fc2.weight": (do, hid),
                       p + "mlp.fc2.bias": (do,)})
        for x in ("q", "k", "v") if b["pool_q"] else ("k", "v"):
            shapes.update({p + f"attn.pool_{x}.weight": (hd, 1, 3, 3, 3),
                           p + f"attn.norm_{x}.weight": (hd,),
                           p + f"attn.norm_{x}.bias": (hd,)})
        if d != do:
            shapes.update({p + "proj.weight": (do, d), p + "proj.bias": (do,)})
    last = bl[-1]["dim_out"]
    shapes.update({m + "norm_embed.weight": (last,),
                   m + "norm_embed.bias": (last,),
                   "model.decoder_pred.weight": (cfg["feature_dim"], last),
                   "model.decoder_pred.bias": (cfg["feature_dim"],)})
    return {n: (s, 1.0 if n.endswith(("norm1.weight", "norm2.weight",
                                      "norm_q.weight", "norm_k.weight",
                                      "norm_v.weight", "norm_embed.weight"))
                else 0.0,
                cfg["norm_std"] if "norm" in n.rsplit(".", 2)[-2]
                else cfg["weight_std"])
            for n, s in shapes.items()}


def _ln(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"],
                        p[name + ".bias"], EPS)


def _pool(ops, p, pre, x, cls, thw, stride, heads):
    """The depthwise conv over the patch tokens x (B, L, C), then the
    per-head LayerNorm of the patch and cls tokens apart."""
    B, L, C = x.shape
    w = p[pre + ".weight"]
    w = w.repeat(C // w.shape[0], 1, 1, 1, 1)
    u = ops.conv3d(x.reshape(B, *thw, C).permute(0, 4, 1, 2, 3), w, stride,
                   [1, 1, 1], groups=C)
    new_thw = tuple(u.shape[2:])
    u = u.permute(0, 2, 3, 4, 1).reshape(B, -1, C)
    norm = pre.replace("pool_", "norm_")
    per_head = lambda t: _ln(t.reshape(t.shape[0], t.shape[1], heads, -1),
                             p, norm).reshape(t.shape)
    return per_head(u), per_head(cls), new_thw


def _block(ops, p, pre, b, x, x_cls, thw):
    B, L, C = x.shape
    heads = b["heads"]
    hd = C // heads
    xn, cn = _ln(x, p, pre + "norm1"), _ln(x_cls, p, pre + "norm1")
    qkv = ops.linear(xn, p[pre + "attn.qkv.weight"], p[pre + "attn.qkv.bias"])
    qkv_c = ops.linear(cn, p[pre + "attn.qkv.weight"],
                       p[pre + "attn.qkv.bias"])
    part = lambda t, i: t[..., i * C:(i + 1) * C]
    q, qc, q_thw = part(qkv, 0), part(qkv_c, 0), thw
    if b["pool_q"]:
        q, qc, q_thw = _pool(ops, p, pre + "attn.pool_q", q, qc, thw,
                             b["stride_q"], heads)
    k, kc, _ = _pool(ops, p, pre + "attn.pool_k", part(qkv, 1),
                     part(qkv_c, 1), thw, b["stride_kv"], heads)
    v, vc, _ = _pool(ops, p, pre + "attn.pool_v", part(qkv, 2),
                     part(qkv_c, 2), thw, b["stride_kv"], heads)
    k, v = torch.cat([kc, k], 1), torch.cat([vc, v], 1)
    split = lambda t: t.reshape(B, t.shape[1], heads, hd).transpose(1, 2)
    kh, vh = split(k), split(v)
    attend = lambda q: ops.matmul(torch.softmax(
        ops.matmul(split(q), kh.transpose(-1, -2)) * hd ** -0.5, dim=-1), vh
    ).transpose(1, 2).reshape(B, q.shape[1], C)
    proj = lambda t: ops.linear(t, p[pre + "attn.proj.weight"],
                                p[pre + "attn.proj.bias"])
    out, out_c = proj(attend(q)), proj(attend(qc))
    if b["pool_q"]:
        kernel = [s + 1 if s > 1 else s for s in b["stride_q"]]
        x = F.max_pool3d(x.reshape(B, *thw, C).permute(0, 4, 1, 2, 3), kernel,
                         b["stride_q"], [k // 2 for k in kernel])
        x = x.permute(0, 2, 3, 4, 1).reshape(B, -1, C)
    x, x_cls = x + out, x_cls + out_c
    xn, cn = _ln(x, p, pre + "norm2"), _ln(x_cls, p, pre + "norm2")
    mlp = lambda t: ops.linear(F.gelu(ops.linear(
        t, p[pre + "mlp.fc1.weight"], p[pre + "mlp.fc1.bias"])),
        p[pre + "mlp.fc2.weight"], p[pre + "mlp.fc2.bias"])
    h, hc = mlp(xn), mlp(cn)
    if b["dim"] != b["dim_out"]:
        x = ops.linear(xn, p[pre + "proj.weight"], p[pre + "proj.bias"])
        x_cls = ops.linear(cn, p[pre + "proj.weight"], p[pre + "proj.bias"])
    return x + h, x_cls + hc, q_thw


def predictions(params, video, mask, cfg, ops):
    """video (B, T, C, H, W), mask (B, T', h, w) -> (B, T, h, w, 108)."""
    p, m = params, "model.mvit."
    st = cfg["conv_patch_embed_stride"]
    x = ops.conv3d(video.permute(0, 2, 1, 3, 4),
                   p["model.patch_embed.patch_model.weight"], st,
                   cfg["conv_patch_embed_padding"],
                   bias=p["model.patch_embed.patch_model.bias"])
    thw = tuple(x.shape[2:])
    x = x.flatten(2).transpose(1, 2)
    B, _, D = x.shape
    dr = 2 ** len(cfg["pool_q_stride_size"])
    w = mask.repeat_interleave(dr, 2).repeat_interleave(dr, 3)
    w = w.reshape(B, -1, 1).float()
    x = x * (1 - w) + p["model.mask_token"] * w
    enc = m + "cls_positional_encoding."
    x_cls = (p[enc + "cls_token"] + p[enc + "pos_embed_class"]).expand(B, 1, D)
    x = x + (p[enc + "pos_embed_spatial"].repeat(1, thw[0], 1)
             + p[enc + "pos_embed_temporal"].repeat_interleave(
                 thw[1] * thw[2], dim=1))
    for i, b in enumerate(blocks(cfg)):
        x, x_cls, thw = _block(ops, p, f"{m}blocks.{i}.", b, x, x_cls, thw)
    feats = _ln(torch.cat([x_cls, x], 1), p, m + "norm_embed")
    preds = ops.linear(feats, p["model.decoder_pred.weight"],
                       p["model.decoder_pred.bias"])[:, 1:]
    dt = st[0]
    t, h, w_ = thw
    preds = preds.reshape(B, t, h, w_, dt, -1).permute(0, 1, 4, 2, 3, 5)
    return preds.reshape(B, t * dt, h, w_, -1)


def loss_mask(batch, cfg):
    """(B, T, h, w): the cube mask over frames, kept at each cube's
    center frame only."""
    dt = cfg["conv_patch_embed_stride"][0]
    mask, markers, counts_ = (batch["mask"], batch["cube_marker"],
                              batch["cube_count"])
    m16 = mask.repeat_interleave(dt, 1).float()
    centers = markers[..., 0] * dt + markers[..., 1] * dt // 2
    valid = (torch.arange(markers.shape[1], device=mask.device)[None]
             < counts_[:, None]).float()
    frames = torch.arange(m16.shape[1], device=mask.device)
    onehot = (centers[..., None] == frames).float() * valid[..., None]
    return m16 * onehot.sum(1).clamp(0, 1)[:, :, None, None]


def train_draws(g, cfg, batch, device):
    raw = batch["raw_video"]
    return {"aug": augment.draw(g, raw.shape, cfg["augment"], device)}


def train_loss(params, batch, draws, lo, hi, cfg, ops):
    """Clips [lo, hi)'s share of the step's masked loss (the masked count
    is the whole batch's)."""
    video, raw = augment.augment(batch["raw_video"][lo:hi],
                                 augment.rows(draws["aug"], lo, hi),
                                 cfg["augment"], cfg["img_size"],
                                 with_raw=True)
    target = hog.cube_targets(raw, batch["cube_marker"][lo:hi],
                              batch["cube_count"][lo:hi])
    m16 = loss_mask(batch, cfg)
    preds = predictions(params, video, batch["mask"][lo:hi], cfg, ops)
    err = ((preds - target) ** 2).mean(-1)
    return (err * m16[lo:hi]).sum() / (m16.sum() + 1e-5)
