"""ViViT with joint space-time attention (Model 1), plain, and its train
step's draws.

Follows Arnab et al., "ViViT: A Video Vision Transformer"
(arXiv:2103.15691), Model 1, as the original PyTorch repo parameterises
it and as ``models/vivit.py`` and ``ops/blocks.py`` of the port implement
it, under the port's parameter names: a tubelet embedding (a tube x ps x
ps product per tubelet, weight laid out as a Conv3d's (D, C, tube, ps,
ps)) -> T' = frames / tube effective frames of P patches -> the cls token
and the spatial position table (P + 1 slots) on every effective frame ->
the time table (T' slots) on the patches -> tokens in patch-major order
``b (p t) d`` after the cls row, 1 + P·T' of them; each block is prenorm
MHSA over every token of the clip and the prenorm MLP (exact erf GELU),
each with its residual and DropPath; the final LayerNorm (eps 1e-6) and
the cls row into the linear head. Block LayerNorms use eps 1e-5.

Departures from the paper, all the original repo's (and the port's):

- the position embedding is factorised into a spatial table of P + 1
  slots and a temporal table of T' slots, where the paper learns one
  embedding a token;
- block LayerNorms take eps 1e-5 (torch's default), where the paper's
  ViT initialisation uses 1e-6; the final LayerNorm keeps 1e-6;
- DropPath (stochastic depth) at the port's rate, per clip, in both
  branches of every block; the paper's regularisers (label smoothing,
  mixup) are not in the step.

Every product runs in float32 with TF32 off: the forward enters
``precision.no_tf32``, and the caller runs the backward inside it too
(``drivers/train.py::reference_record`` does). Attention is computed one
block of ``QUERY_BLOCK`` queries at a time, so that the scores of a
3137-token clip never exist whole at once; autograd still keeps each
block's probabilities for the backward (12 x 3137² x 4 B = 472 MB a clip
a layer at the published size).

DropPath keeps clip r with ``floor(keep + u_r)``, u drawn in the working
type (bf16) from the step's generator, and scales by 1 / keep; per layer
of rate > 0 the attention's clips, then the MLP's, drawn for the whole
batch in block order as the program draws them (``drop_path_draws``).
Layer i's rate is linspace(0, rate, depth)[i]; at rate 0 nothing is
drawn.
"""

import numpy as np
import torch

from vtbench.reference import precision

LN_EPS, FINAL_EPS = 1e-5, 1e-6
QUERY_BLOCK = 1024


def geometry(cfg):
    """(T', P, tube, patch size) of a configuration."""
    ps, tube = cfg["patch_size"], cfg["tube_size"]
    return cfg["num_frames"] // tube, (cfg["img_size"] // ps) ** 2, tube, ps


def param_specs(cfg):
    """{name: (shape, mean, std)} of the model and head, the port's names
    (``model.`` and ``cls_head.``) and the benchmark's weight draw:
    LayerNorm weights around 1, everything else around 0."""
    D, C = cfg["embed_dims"], cfg["in_channels"]
    T, P, tube, ps = geometry(cfg)
    hid = D * cfg["mlp_ratio"]
    shapes = {"model.patch_embed.projection.weight": (D, C, tube, ps, ps),
              "model.patch_embed.projection.bias": (D,),
              "model.cls_token": (1, 1, D), "model.pos_embed": (1, P + 1, D),
              "model.time_embed": (1, T, D), "model.norm.weight": (D,),
              "model.norm.bias": (D,),
              "cls_head.cls_head.weight": (cfg["num_class"], D),
              "cls_head.cls_head.bias": (cfg["num_class"],)}
    for i in range(cfg["num_transformer_layers"]):
        pre = f"model.transformer_layers.layers.{i}."
        att, ffn = pre + "attentions.0.", pre + "ffns.0."
        shapes.update({att + "norm.weight": (D,), att + "norm.bias": (D,),
                       att + "attn.qkv.weight": (3 * D, D),
                       att + "attn.qkv.bias": (3 * D,),
                       att + "attn.proj.weight": (D, D),
                       att + "attn.proj.bias": (D,),
                       ffn + "norm.weight": (D,), ffn + "norm.bias": (D,),
                       ffn + "layers.0.0.weight": (hid, D),
                       ffn + "layers.0.0.bias": (hid,),
                       ffn + "layers.1.weight": (D, hid),
                       ffn + "layers.1.bias": (D,)})
    return {n: (s, 1.0 if n.endswith("norm.weight") else 0.0,
                cfg["norm_std"] if "norm." in n else cfg["weight_std"])
            for n, s in shapes.items()}


def rates(cfg):
    return [float(r) for r in np.linspace(0, cfg["drop_path_rate"],
                                          cfg["num_transformer_layers"])]


def drop_path_draws(g, cfg, clips, device, dtype=torch.bfloat16):
    """Every DropPath factor of one train step over ``clips`` clips, in the
    program's draw order: per layer of rate > 0 the attention's clips and
    the MLP's, each (clips,) float32 equal to floor(keep + u) / keep with u
    and the floor in ``dtype``."""
    out = []
    for rate in rates(cfg):
        if rate == 0.0:
            out.append(None)
            continue
        keep = 1.0 - rate
        layer = []
        for _ in range(2):
            u = torch.rand((clips, 1, 1), generator=g, dtype=dtype,
                           device=device)
            layer.append(torch.floor(keep + u).float().view(clips) / keep)
        out.append(layer)
    return out


def drop_rows(drops, lo, hi):
    """The factors of clips [lo, hi)."""
    return [None if d is None else [f[lo:hi] for f in d] for d in drops]


def _ln(x, w, b, eps):
    return torch.nn.functional.layer_norm(x, x.shape[-1:], w, b, eps)


def attention(ops, q, k, v, scale):
    """softmax(q kᵀ · scale) v over (B, H, N, hd), QUERY_BLOCK queries at
    a time."""
    kt = k.transpose(-1, -2)
    out = [ops.matmul(torch.softmax(ops.matmul(q[:, :, i:i + QUERY_BLOCK], kt)
                                    * scale, dim=-1), v)
           for i in range(0, q.shape[2], QUERY_BLOCK)]
    return torch.cat(out, dim=2)


def _mhsa(ops, x, p, pre, heads):
    """Prenorm joint MHSA of x (B, N, D), no residual."""
    B, N, D = x.shape
    hd = D // heads
    xn = _ln(x, p[pre + "norm.weight"], p[pre + "norm.bias"], LN_EPS)
    qkv = ops.linear(xn, p[pre + "attn.qkv.weight"], p[pre + "attn.qkv.bias"])
    q, k, v = qkv.reshape(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    o = attention(ops, q, k, v, hd ** -0.5)
    o = o.transpose(1, 2).reshape(B, N, D)
    return ops.linear(o, p[pre + "attn.proj.weight"],
                      p[pre + "attn.proj.bias"])


def _gelu(h):
    return 0.5 * h * (1.0 + torch.erf(h * 0.7071067811865476))


def tokens(params, video, cfg, ops):
    """video (b, t, c, h, w) float32 -> (b, 1 + P·T', D): the tubelet
    embedding, the cls row and both position tables (module doc)."""
    p = params
    b, t, c, h, w = video.shape
    D = cfg["embed_dims"]
    T, P, tube, ps = geometry(cfg)
    gh, gw = h // ps, w // ps
    # (b T', tube, c, gh, ps, gw, ps) -> (b T', P, c·tube·ps·ps), the order
    # of the Conv3d weight's (in, kt, kh, kw)
    x = video.reshape(b * T, tube, c, gh, ps, gw, ps).permute(
        0, 3, 5, 2, 1, 4, 6).reshape(b * T, gh * gw, c * tube * ps * ps)
    wp = p["model.patch_embed.projection.weight"].reshape(D, -1)
    x = ops.linear(x, wp, p["model.patch_embed.projection.bias"])
    pos = p["model.pos_embed"]
    cls = (p["model.cls_token"] + pos[:, :1]).expand(b, 1, D)
    patches = (x + pos[:, 1:]).reshape(b, T, P, D).transpose(1, 2)
    patches = patches + p["model.time_embed"][:, None]
    return torch.cat([cls, patches.reshape(b, P * T, D)], dim=1)


@precision.no_tf32()
def features(params, video, cfg, ops, drops=None):
    """video (b, t, c, h, w) float32 -> (b, D) cls features; ``drops``:
    ``drop_path_draws`` of these clips (training), or None (eval)."""
    p = params
    x = tokens(params, video, cfg, ops)
    for i in range(cfg["num_transformer_layers"]):
        pre = f"model.transformer_layers.layers.{i}."
        fac = None if drops is None else drops[i]
        y = _mhsa(ops, x, p, pre + "attentions.0.", cfg["num_heads"])
        if fac is not None:
            y = y * fac[0].view(-1, 1, 1)
        x = x + y
        f = pre + "ffns.0."
        hid = ops.linear(_ln(x, p[f + "norm.weight"], p[f + "norm.bias"],
                             LN_EPS),
                         p[f + "layers.0.0.weight"], p[f + "layers.0.0.bias"])
        y = ops.linear(_gelu(hid), p[f + "layers.1.weight"],
                       p[f + "layers.1.bias"])
        if fac is not None:
            y = y * fac[1].view(-1, 1, 1)
        x = x + y
    return _ln(x[:, 0], p["model.norm.weight"], p["model.norm.bias"],
               FINAL_EPS)


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
                 drop_rows(draws["drop"], lo, hi))
    logp = torch.log_softmax(out, dim=-1)
    return -logp.gather(-1, batch["label"][lo:hi, None].long()).sum() / total
