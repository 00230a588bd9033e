"""ViViT (Arnab et al., arXiv:2103.15691) with joint space-time attention
(Model 1) in the benchmark: its plain reference and its counts.

The counts are those of joint space-time attention, the only type they
know; any other ``attention_type`` raises. There is no ``serving_model``:
no cell serves this model. The kernel calls are those of
``ops/blocks.py::JointAttention`` and ``FFN``: up to ``FUSED_MHSA_MAX_N``
tokens a clip is one fused prenorm-MHSA call (B1 forward, B3 backward);
above it the unfused form, whose only hand-written kernel is flash
attention on (clips, heads, N, N, hd) (B5, B6), its LayerNorm, products
and layout copies being PyTorch's; the MLP is B2/B4 on every token.
"""

from vtbench.counts import b1, b2, b3, b4, b5, b6
from vtbench.reference import vivit as reference

COUNTED = "joint_space_time"
# a frozen copy of ops/blocks.py::FUSED_MHSA_MAX_N of the port: the longest
# sequence joint attention gives the fused prenorm-MHSA call
FUSED_MHSA_MAX_N = 2048


def geometry(cfg):
    if cfg["attention_type"] != COUNTED:
        raise ValueError(f"ViViT counts know {COUNTED} only, not "
                         f"{cfg['attention_type']}")
    T, P, tube, ps = reference.geometry(cfg)
    D = cfg["embed_dims"]
    return dict(T=T, P=P, N=1 + P * T, D=D, H=cfg["num_heads"],
                layers=cfg["num_transformer_layers"],
                hidden=D * cfg["mlp_ratio"],
                pix=tube * ps * ps * cfg["in_channels"],
                classes=cfg["num_class"])


def fwd_flops(cfg, clips):
    """Model FLOPs of ViViT joint space-time over ``clips`` clips: the
    tubelet product 2·T'·P·pix·D, per layer 8·N·D² (qkv and projection),
    4·N²·D (the two attention products) and 16·N·D² (the MLP at ratio 4,
    written for the configuration's ratio), and the head."""
    g = geometry(cfg)
    N, D = g["N"], g["D"]
    patch = 2 * g["T"] * g["P"] * g["pix"] * D
    layer = 8 * N * D * D + 4 * N * N * D + 4 * N * D * g["hidden"]
    return clips * (patch + g["layers"] * layer + 2 * D * g["classes"])


def flash_calls(cfg, clips, backward):
    """The (flops, bytes) of every B5 (and with ``backward`` B6) call of one
    forward over ``clips`` clips: one a layer on (clips, heads, N, N, hd)
    where N passes ``FUSED_MHSA_MAX_N``, else none."""
    g = geometry(cfg)
    if g["N"] <= FUSED_MHSA_MAX_N:
        return []
    shape = (clips, g["H"], g["N"], g["N"], g["D"] // g["H"])
    return ([b5(*shape)] + ([b6(*shape)] if backward else [])) * g["layers"]


def kernel_calls(cfg, clips, backward):
    """The (flops, bytes) of every hand-written kernel call of one forward
    (and with ``backward`` its backward) over ``clips`` clips: per layer
    B5 (B6) where N passes ``FUSED_MHSA_MAX_N``, else B1 (B3) on ``clips``
    sequences of N, and B2 (B4) on all clips·N tokens."""
    g = geometry(cfg)
    N, D, H = g["N"], g["D"], g["H"]
    ffn = [b2(clips * N, D, g["hidden"])] + (
        [b4(clips * N, D, g["hidden"])] if backward else [])
    if N > FUSED_MHSA_MAX_N:
        return flash_calls(cfg, clips, backward) + ffn * g["layers"]
    mhsa = [b1(clips, N, D, heads=H)] + (
        [b3(clips, N, D, heads=H)] if backward else [])
    return (mhsa + ffn) * g["layers"]
