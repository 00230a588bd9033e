"""TimeSformer (Bertasius et al., arXiv:2102.05095) in the benchmark: its
plain reference, its counts, and the port's model for the serve driver.

The counts are those of divided space-time attention, the only type they
know; any other ``attention_type`` raises. The forward count is a copy of
``benchmarks/run_all.py::timesformer_fwd_flops`` of the port, with the
classification head added; the kernel calls are those of ``ops/blocks.py``
(B1/B3: ``fused_mhsa.fused_prenorm_mhsa``; B2/B4:
``fused_ffn.fused_prenorm_ffn``).
"""

from vtbench.counts import b1, b2, b3, b4
from vtbench.reference import timesformer as reference

COUNTED = "divided_space_time"


def geometry(cfg):
    if cfg["attention_type"] != COUNTED:
        raise ValueError(f"TimeSformer counts know {COUNTED} only, not "
                         f"{cfg['attention_type']}")
    img, ps = cfg["img_size"], cfg["patch_size"]
    return dict(T=cfg["num_frames"], P=(img // ps) ** 2, D=cfg["embed_dims"],
                H=cfg["num_heads"], layers=cfg["num_transformer_layers"],
                hidden=cfg["embed_dims"] * cfg["mlp_ratio"],
                pix=ps * ps * cfg["in_channels"], classes=cfg["num_class"])


def fwd_flops(cfg, views):
    """Model FLOPs of TimeSformer divided space-time over ``views`` clips,
    with the classification head."""
    g = geometry(cfg)
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


def kernel_calls(cfg, views, backward):
    """The (flops, bytes) of every B1-B4 call of one forward (and with
    ``backward`` its backward) over ``views`` clips: per layer B1 on the
    temporal rows (views·P sequences of T) and on the spatial rows
    (views·T sequences of 1 + P), B2 on all views·(P·T + 1) tokens."""
    g = geometry(cfg)
    T, P, D, H = g["T"], g["P"], g["D"], g["H"]
    per_layer = [b1(views * P, T, D, heads=H),
                 b1(views * T, P + 1, D, heads=H),
                 b2(views * (P * T + 1), D, g["hidden"])]
    if backward:
        per_layer += [b3(views * P, T, D, heads=H),
                      b3(views * T, P + 1, D, heads=H),
                      b4(views * (P * T + 1), D, g["hidden"])]
    return per_layer * g["layers"]


def serving_model(cfg):
    """The port's TimeSformer and classification head at the
    configuration's sizes."""
    from videotransformer_tpu_torch.models.timesformer import TimeSformer
    from videotransformer_tpu_torch.ops.blocks import ClassificationHead

    model = TimeSformer(num_frames=cfg["num_frames"],
                        img_size=cfg["img_size"],
                        patch_size=cfg["patch_size"],
                        embed_dims=cfg["embed_dims"],
                        num_heads=cfg["num_heads"],
                        num_transformer_layers=cfg["num_transformer_layers"],
                        attention_type=cfg["attention_type"])
    return model, ClassificationHead(cfg["num_class"], cfg["embed_dims"])
