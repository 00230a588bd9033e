"""TimeSformer with divided space-time attention, plain, and its train
step's draws.

Follows Bertasius et al. (arXiv:2102.05095) as ``models/timesformer.py``
and ``ops/blocks.py`` of the port implement it, under the port's parameter
names: patch embed (a ps x ps product per frame) -> cls token -> spatial
position table -> time table on the patches -> tokens in patch-major
order ``b (p t) d``; each block is the temporal attention over each
patch's T frames (prenorm, no cls token, then ``temporal_fc``), the
spatial attention over each frame's patches with the cls token replicated
per frame and averaged back, and the prenorm MLP (exact erf GELU), each
with its residual and DropPath; the final LayerNorm (eps 1e-6) and the
cls row into the linear head. Block LayerNorms use eps 1e-5.

DropPath keeps row r with ``floor(keep + u_r)``, u drawn in the working
type (bf16) from the step's generator, and scales by 1 / keep; rows are
the temporal sequences (b·p), the spatial sequences (b·t) and the clips
(b), drawn for the whole batch in block order as the program draws them
(``drop_path_draws``). Layer i's rate is linspace(0, rate, depth)[i]; at
rate 0 nothing is drawn.
"""

import numpy as np
import torch

LN_EPS, FINAL_EPS = 1e-5, 1e-6


def param_specs(cfg):
    """{name: (shape, mean, std)} of the model and head, the port's names
    (``model.`` and ``cls_head.``) and the benchmark's weight draw: LayerNorm
    weights around 1, everything else around 0."""
    D, C, ps = cfg["embed_dims"], cfg["in_channels"], cfg["patch_size"]
    P = (cfg["img_size"] // ps) ** 2
    T, hid = cfg["num_frames"], cfg["embed_dims"] * cfg["mlp_ratio"]
    w = cfg["weight_std"]
    shapes = {"model.patch_embed.projection.weight": (D, C, ps, ps),
              "model.patch_embed.projection.bias": (D,),
              "model.cls_token": (1, 1, D), "model.pos_embed": (1, P + 1, D),
              "model.time_embed": (1, T, D), "model.norm.weight": (D,),
              "model.norm.bias": (D,),
              "cls_head.cls_head.weight": (cfg["num_class"], D),
              "cls_head.cls_head.bias": (cfg["num_class"],)}
    for i in range(cfg["num_transformer_layers"]):
        pre = f"model.transformer_layers.layers.{i}."
        for a in (0, 1):
            att = f"{pre}attentions.{a}."
            shapes.update({att + "norm.weight": (D,), att + "norm.bias": (D,),
                           att + "attn.qkv.weight": (3 * D, D),
                           att + "attn.qkv.bias": (3 * D,),
                           att + "attn.proj.weight": (D, D),
                           att + "attn.proj.bias": (D,)})
        shapes.update({pre + "attentions.0.temporal_fc.weight": (D, D),
                       pre + "attentions.0.temporal_fc.bias": (D,),
                       pre + "ffns.0.norm.weight": (D,),
                       pre + "ffns.0.norm.bias": (D,),
                       pre + "ffns.0.layers.0.0.weight": (hid, D),
                       pre + "ffns.0.layers.0.0.bias": (hid,),
                       pre + "ffns.0.layers.1.weight": (D, hid),
                       pre + "ffns.0.layers.1.bias": (D,)})
    return {n: (s, 1.0 if n.endswith("norm.weight") else 0.0,
                cfg["norm_std"] if "norm." in n else w)
            for n, s in shapes.items()}


def rates(cfg):
    return [float(r) for r in np.linspace(0, cfg["drop_path_rate"],
                                          cfg["num_transformer_layers"])]


def drop_path_draws(g, cfg, clips, device, dtype=torch.bfloat16):
    """Every DropPath factor of one train step over ``clips`` clips, in the
    program's draw order: per layer of rate > 0 the temporal rows (clips·P),
    the spatial rows (clips·T) and the clips, each (rows,) float32 equal to
    floor(keep + u) / keep with u and the floor in ``dtype``."""
    P = (cfg["img_size"] // cfg["patch_size"]) ** 2
    T = cfg["num_frames"]
    out = []
    for rate in rates(cfg):
        if rate == 0.0:
            out.append(None)
            continue
        keep = 1.0 - rate
        layer = []
        for n in (clips * P, clips * T, clips):
            u = torch.rand((n, 1, 1), generator=g, dtype=dtype, device=device)
            layer.append(torch.floor(keep + u).float().view(n) / keep)
        out.append(layer)
    return out


def drop_rows(drops, lo, hi, cfg):
    """The factors of clips [lo, hi) (rows are clip-major)."""
    P = (cfg["img_size"] // cfg["patch_size"]) ** 2
    T = cfg["num_frames"]
    return [None if d is None else
            [d[0][lo * P:hi * P], d[1][lo * T:hi * T], d[2][lo:hi]]
            for d in drops]


def _ln(x, w, b, eps):
    return torch.nn.functional.layer_norm(x, x.shape[-1:], w, b, eps)


def _mhsa(ops, x, p, pre, heads):
    """Prenorm MHSA of x (S, L, D), no residual."""
    S, L, D = x.shape
    hd = D // heads
    xn = _ln(x, p[pre + "norm.weight"], p[pre + "norm.bias"], LN_EPS)
    qkv = ops.linear(xn, p[pre + "attn.qkv.weight"], p[pre + "attn.qkv.bias"])
    q, k, v = qkv.reshape(S, L, 3, heads, hd).permute(2, 0, 3, 1, 4)
    s = ops.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
    o = ops.matmul(torch.softmax(s, dim=-1), v)
    o = o.transpose(1, 2).reshape(S, L, D)
    return ops.linear(o, p[pre + "attn.proj.weight"],
                      p[pre + "attn.proj.bias"])


def _gelu(h):
    return 0.5 * h * (1.0 + torch.erf(h * 0.7071067811865476))


def features(params, video, cfg, ops, drops=None):
    """video (b, t, c, h, w) float32 -> (b, D) cls features; ``drops``:
    ``drop_path_draws`` of these clips (training), or None (eval)."""
    p = params
    b, t, c, h, w = video.shape
    ps, D, H = cfg["patch_size"], cfg["embed_dims"], cfg["num_heads"]
    gh, gw = h // ps, w // ps
    x = video.reshape(b * t, c, gh, ps, gw, ps).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(b * t, gh * gw, c * ps * ps)
    wp = p["model.patch_embed.projection.weight"].reshape(D, -1)
    x = ops.linear(x, wp, p["model.patch_embed.projection.bias"])
    P = x.shape[1]
    x = torch.cat([p["model.cls_token"].expand(b * t, 1, D), x], dim=1)
    x = x + p["model.pos_embed"]
    cls = x[:b, :1]
    patches = x[:, 1:].reshape(b, t, P, D).transpose(1, 2)
    patches = patches + p["model.time_embed"]
    x = torch.cat([cls, patches.reshape(b, P * t, D)], dim=1)
    for i in range(cfg["num_transformer_layers"]):
        pre = f"model.transformer_layers.layers.{i}."
        fac = None if drops is None else drops[i]
        # temporal: rows (b·p) of t frames, no cls, temporal_fc
        cls, pt = x[:, :1], x[:, 1:]
        y = _mhsa(ops, pt.reshape(b * P, t, D), p, pre + "attentions.0.", H)
        if fac is not None:
            y = y * fac[0].view(-1, 1, 1)
        y = ops.linear(y, p[pre + "attentions.0.temporal_fc.weight"],
                       p[pre + "attentions.0.temporal_fc.bias"])
        x = torch.cat([cls, pt + y.reshape(b, P * t, D)], dim=1)
        # spatial: rows (b·t) of the cls token and p patches
        cls, pt = x[:, :1], x[:, 1:]
        s = pt.reshape(b, P, t, D).transpose(1, 2).reshape(b * t, P, D)
        s = torch.cat([cls[:, None].expand(b, t, 1, D).reshape(b * t, 1, D),
                       s], dim=1)
        y = _mhsa(ops, s, p, pre + "attentions.1.", H)
        if fac is not None:
            y = y * fac[1].view(-1, 1, 1)
        new_cls = y[:, 0].reshape(b, t, D).mean(1, keepdim=True)
        y = y[:, 1:].reshape(b, t, P, D).transpose(1, 2).reshape(b, P * t, D)
        x = x + torch.cat([new_cls, y], dim=1)
        # MLP
        f = pre + "ffns.0."
        hid = ops.linear(_ln(x, p[f + "norm.weight"], p[f + "norm.bias"],
                             LN_EPS),
                         p[f + "layers.0.0.weight"], p[f + "layers.0.0.bias"])
        y = ops.linear(_gelu(hid), p[f + "layers.1.weight"],
                       p[f + "layers.1.bias"])
        if fac is not None:
            y = y * fac[2].view(-1, 1, 1)
        x = x + y
    x = _ln(x, p["model.norm.weight"], p["model.norm.bias"], FINAL_EPS)
    return x[:, 0]


def logits(params, video, cfg, ops, drops=None):
    f = features(params, video, cfg, ops, drops)
    return ops.linear(f, params["cls_head.cls_head.weight"],
                      params["cls_head.cls_head.bias"])


# ------------------------------------------------------------ a train step

def train_draws(g, cfg, batch, device):
    """The step's draws from the step's generator, in the program's
    order: the augment's for the whole batch, then DropPath's."""
    from vtbench.reference import augment

    raw = batch["raw_video"]
    return {"aug": augment.draw(g, raw.shape, cfg["augment"], device),
            "drop": drop_path_draws(g, cfg, raw.shape[0], device)}


def train_loss(params, batch, draws, lo, hi, cfg, ops):
    """Clips [lo, hi)'s share of the step's mean cross entropy: the train
    augment from the step's draws, the forward with DropPath, the head."""
    from vtbench.reference import augment

    total = batch["raw_video"].shape[0]
    video = augment.augment(batch["raw_video"][lo:hi],
                            augment.rows(draws["aug"], lo, hi),
                            cfg["augment"], cfg["img_size"])
    out = logits(params, video, cfg, ops,
                 drop_rows(draws["drop"], lo, hi, cfg))
    logp = torch.log_softmax(out, dim=-1)
    return -logp.gather(-1, batch["label"][lo:hi, None].long()).sum() / total
