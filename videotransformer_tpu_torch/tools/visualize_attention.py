"""Attention-rollout visualisation (DINO-style) of TimeSformer on the port.

Port of ``videotransformer_tpu/tools/visualize_attention.py`` (reference
visualize_attention.py:179-256): build TimeSformer-B/16 divided at 8x224,
optionally load an original-repo Kinetics checkpoint (``models/convert.py``),
decode a clip (``data/video_reader.py``) through the eval transform, take
the last block's spatial attention (``return_attention=True``: (T, heads,
197, 197)) and keep its cls rows on the device, then per frame and head:

- the cls token's attention over the 196 patches as a (14, 14) heatmap,
- a mask keeping ``threshold`` of the attention mass
  (visualize_attention.py:66-102), nearest-upsampled by the patch size,
- colored masks over a dimmed grayscale frame (visualize_attention.py:
  104-177),

and saves ``attn_img{i}.png`` per frame: [frame | colored overlay | heads].

Two stages: ``cls_attention`` (the model on the device -> the cls rows)
and ``render`` (numpy and PIL on the host). The numpy stages
are the JAX tool's; ``colormap`` reads matplotlib's viridis from a copy of
its table (the card's machine has no matplotlib). The model runs in bf16
on the card (``--device cuda``, the default) and in fp32 on the CPU.

    python -m videotransformer_tpu_torch.tools.visualize_attention \\
        --video videotransformer_tpu/data/assets/demo/checker_spin_0.mp4 \\
        [--pretrained_weights K400.pth] [--output_dir DIR] [--device cpu]
"""

import argparse
import os

import numpy as np
import torch

from videotransformer_tpu_torch.data import transforms as T
from videotransformer_tpu_torch.data.video_reader import DecordInit
from videotransformer_tpu_torch.models import convert
from videotransformer_tpu_torch.models.timesformer import TimeSformer
from videotransformer_tpu_torch.utils.helpers import (
    denormalize, resolve_device)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEMO_DIR = os.path.join(REPO, "videotransformer_tpu", "data", "assets", "demo")
MEAN, STD = (0.45, 0.45, 0.45), (0.225, 0.225, 0.225)
COMPANY_COLORS = [
    (0.266, 0.447, 0.768), (0.929, 0.490, 0.192), (0.255, 0.572, 0.243),
    (0.768, 0.305, 0.321), (0.459, 0.325, 0.650), (0.898, 0.768, 0.196),
]
# matplotlib's viridis lookup table as uint8 RGB (its float table · 255,
# truncated): 256 colors, then the under, over and bad entries
VIRIDIS = np.frombuffer(bytes.fromhex(
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163"
    "47126547146647156747166947186a48196b481a6c481c6e481d6f481e70482071482172"
    "482273482374472575472676472777472878472a79472b7a472c7b462d7c462f7c46307d"
    "46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
    "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c89"
    "3c4d8a3c4e8a3b508a3b518a3a528b3a538b39548b39558b38568b38578c37588c37598c"
    "365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d32628d32638d31648d31658d"
    "31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e"
    "277d8e277e8e267f8e26808e26818e25828e25838d24848d24858d24868d23878d23888d"
    "23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c20908c20918c1f928c1f938b"
    "1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
    "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a982"
    "24aa8225ab8126ac8127ad8028ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a"
    "32b57a33b67935b77836b87738b97639b9763bba753dbb743ebc7340bd7242be7144be70"
    "45bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d052"
    "79d1517cd24f7ed24e81d34c83d34b86d44988d5478bd5468dd64490d64392d74195d73f"
    "97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32addc30afdc2eb2dd2cb5dd2b"
    "b7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
    "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51e"
    "f6e61ff8e621fae622fde724440154fde724000000"), np.uint8).reshape(259, 3)


def mass_threshold_masks(cls_attn, threshold, grid):
    """cls_attn (nh, P) -> boolean masks (nh, grid, grid) keeping `threshold`
    of the attention mass (reference visualize_attention.py:71-84)."""
    nh, P = cls_attn.shape
    order = np.argsort(cls_attn, axis=1)
    val = np.take_along_axis(cls_attn, order, axis=1)
    val = val / val.sum(axis=1, keepdims=True)
    cumval = np.cumsum(val, axis=1)
    th = cumval > (1 - threshold)
    inv = np.argsort(order, axis=1)
    th_attn = np.take_along_axis(th, inv, axis=1)
    return th_attn.reshape(nh, grid, grid).astype(np.float32)


def upsample_nearest(x, factor):
    return np.repeat(np.repeat(x, factor, axis=-2), factor, axis=-1)


def overlay_colors(frame_rgb, attn_maps, th_masks, heads=None):
    """Colored compositing (reference show_attn_color, :104-177):
    dim grayscale base + per-head colored masks, strongest head wins."""
    if heads is None:
        heads = tuple(range(min(6, attn_maps.shape[0])))
    img = frame_rgb.astype(np.float32)
    m, M = img.min(), img.max()
    span = 64
    img = ((img - m) / max(M - m, 1e-6)) * span + (256 - span)
    gray = img.mean(axis=2, keepdims=True).repeat(3, axis=2)

    masks = np.stack([attn_maps[j] * th_masks[j] for j in heads])
    # strongest head wins per pixel
    winner = masks == masks.max(axis=0, keepdims=True)
    masks = masks * winner
    a = np.cumsum(masks, axis=0)
    masks = masks * (masks == a)

    out = 0.1 * gray
    for i, color in enumerate(COMPANY_COLORS[: len(heads)]):
        mask = masks[i] > 0
        for c in range(3):
            out[..., c] = np.where(
                mask, out[..., c] * (1 - 1.0) + 1.0 * color[c] * 255, out[..., c])
    return np.clip(out, 0, 255).astype(np.uint8)


def colormap(x):
    """The viridis heatmap of x scaled to [0, 1]: ``(cm.viridis(normed)[...,
    :3] * 255).astype(np.uint8)`` by matplotlib's lookup rule (· 256, 1.0 to
    the last color, under / over / NaN to their entries)."""
    normed = (x - x.min()) / max(x.max() - x.min(), 1e-8)
    xa = np.array(normed, copy=True)
    xa *= 256
    xa[xa == 256] = 255
    under, over, bad = xa < 0, xa >= 256, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under], idx[over], idx[bad] = 256, 257, 258
    return VIRIDIS.take(idx, axis=0, mode="clip")


def build_model(args):
    """TimeSformer (divided space-time) at the arguments' geometry, the
    JAX package's initialisation from seed 0, then the checkpoint
    ``args.pretrained_weights`` where given (``init_from_kinetics_
    pretrain``)."""
    model = TimeSformer(
        num_frames=args.num_frames, img_size=args.image_size,
        patch_size=args.patch_size, embed_dims=args.embed_dims,
        num_heads=args.num_heads, num_transformer_layers=args.num_layers,
        attention_type="divided_space_time")
    model.reset_parameters(torch.Generator().manual_seed(0))
    if args.pretrained_weights:
        convert.init_from_kinetics_pretrain(
            model, convert.read_checkpoint(args.pretrained_weights))
    return model


def load_video(args, rng):
    """Decode ``args.video``: a temporal window drawn from the numpy
    Generator ``rng``, ``num_frames`` frames spread over its length from
    frame 0 (as the reference), Resize(-1, 256) -> CenterCrop ->
    Normalize -> (T, C, S, S) float32."""
    reader = DecordInit()(args.video)
    try:
        start, end = T.temporal_window(
            len(reader), args.num_frames * args.frame_interval, rng)
        if end - start < args.num_frames:
            raise ValueError(f"video {args.video} shorter than "
                             f"{args.num_frames} frames")
        indices = np.linspace(0, end - start - 1, args.num_frames, dtype=int)
        video = reader.get_batch(indices).transpose(0, 3, 1, 2).astype(
            np.float32)
    finally:
        reader.close()
    transform = T.Compose([
        T.Resize(scale_range=(-1, 256)), T.CenterCrop(args.image_size),
        T.ToTensor(), T.Normalize(list(MEAN), list(STD))])
    transform.randomize_parameters()
    return transform(video)


@torch.inference_mode()
def cls_attention(model, video):
    """The last block's spatial attention of ``video`` (T, C, S, S) through
    ``model`` in its eval mode, on its device and in its dtype, reduced to
    the cls rows on the device before the copy to the host: (T, heads, 1 +
    P) float32, each row summing to 1 (the full weights are (T, heads, 1 +
    P, 1 + P))."""
    p = next(model.parameters())
    x = torch.from_numpy(video)[None].to(p.device, p.dtype)
    rows = model(x, return_attention=True)[:, :, 0]
    return rows.float().cpu().numpy()


def render(video, cls_rows, args):
    """The render stage: ``attn_img{i}.png`` for each frame into
    ``args.output_dir``; returns their paths."""
    from PIL import Image

    attn_cls = cls_rows[..., 1:]  # the cls token's attention over patches
    grid = args.image_size // args.patch_size
    os.makedirs(args.output_dir, exist_ok=True)
    paths = []
    for i in range(video.shape[0]):
        cls_attn = attn_cls[i]  # (nh, P)
        nh = cls_attn.shape[0]
        th = mass_threshold_masks(cls_attn, args.threshold, grid)
        maps = cls_attn.reshape(nh, grid, grid)
        maps_up = upsample_nearest(maps, args.patch_size)
        th_up = upsample_nearest(th, args.patch_size)

        frame_rgb = denormalize(video[i], MEAN, STD).transpose(1, 2, 0)
        color = overlay_colors(frame_rgb, maps_up, th_up)
        heads_grid = np.concatenate(
            [colormap(maps_up[j]) for j in range(nh)], axis=1)

        h = frame_rgb.shape[0]
        row = np.concatenate([frame_rgb, color], axis=1)
        scale = h / heads_grid.shape[0]
        heads_img = Image.fromarray(
            np.clip(heads_grid, 0, 255).astype(np.uint8)).resize(
            (int(heads_grid.shape[1] * scale), h), Image.NEAREST)
        final = np.concatenate(
            [np.clip(row, 0, 255).astype(np.uint8), np.asarray(heads_img)],
            axis=1)
        paths.append(os.path.join(args.output_dir, f"attn_img{i}.png"))
        Image.fromarray(final).save(paths[-1])
    return paths


def run(args):
    """The clip (T, C, S, S), its temporal window drawn from ``args.seed``,
    and its cls rows (T, heads, 1 + P) from the model on the device (bf16
    on a card, fp32 on the CPU); then the PNGs."""
    device = resolve_device(args.device)
    video = load_video(args, np.random.default_rng(args.seed))
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    cls_rows = cls_attention(build_model(args).to(device, dtype).eval(),
                             video)
    print("cls attention shape:", cls_rows[..., 1:].shape)
    paths = render(video, cls_rows, args)
    print(f"saved {len(paths)} visualizations to {args.output_dir}")
    return video, cls_rows


def parse_args(argv=None):
    p = argparse.ArgumentParser("Visualize Self-Attention maps")
    p.add_argument("--arch", default="timesformer", choices=["timesformer"])
    p.add_argument("--pretrained_weights", default="", type=str)
    p.add_argument("--video",
                   default=os.path.join(DEMO_DIR, "checker_spin_0.mp4"))
    p.add_argument("--output_dir", default="./attention_map")
    p.add_argument("--threshold", type=float, default=0.6)
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--num_frames", type=int, default=8)
    p.add_argument("--frame_interval", type=int, default=32)
    p.add_argument("--embed_dims", type=int, default=768)
    p.add_argument("--num_heads", type=int, default=12)
    p.add_argument("--num_layers", type=int, default=12)
    p.add_argument("--seed", type=int, default=0,
                   help="the temporal window's draw")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
