"""MaskFeat HOG-prediction visualisation on the port.

Port of ``videotransformer_tpu/tools/visualize_maskfeat.py`` (reference
video_transformer.py's visualize branch and its visual check at
:971-1075): decode a clip, draw a cube mask (``data/mask_generator.py``,
from a numpy Generator seeded by ``--seed``), compute the HOG targets at
the cube centres (``data/hog.py::batched_hog_targets``), run MaskFeat on
MViT-B (16x224, depth 16, two q-pool stages) with ``visualize=True`` and
render the triplet the reference renders:

  hog_pred.png  per-cell oriented-line plot of the predicted HOG
                histograms at a mask-cube centre frame
  real_img.png  the original (un-normalized) centre frame
  mask_img.png  the centre frame with the masked patches blanked

Two stages: ``maskfeat_arrays`` (the model on the device) and ``render``
(numpy and PIL on the host). The model runs in bf16 on the card
(``--device cuda``, the default) and in fp32 on the CPU.

    python -m videotransformer_tpu_torch.tools.visualize_maskfeat \\
        [--video CLIP] [--pretrained CKPT] [--output_dir DIR] [--device cpu]
"""

import argparse
import os

import numpy as np
import torch

from videotransformer_tpu_torch.data import transforms as T
from videotransformer_tpu_torch.data.hog import batched_hog_targets
from videotransformer_tpu_torch.data.mask_generator import (
    CubeMaskGenerator, pad_cube_marker)
from videotransformer_tpu_torch.data.video_reader import DecordInit
from videotransformer_tpu_torch.models import convert
from videotransformer_tpu_torch.models.maskfeat import MaskFeat
from videotransformer_tpu_torch.tools.visualize_attention import DEMO_DIR
from videotransformer_tpu_torch.utils.helpers import resolve_device

BUNDLED_DEMO = os.path.join(DEMO_DIR, "checker_spin_0.mp4")
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
HOG_DIM = 2 * 2 * 3 * 9  # a token's 2x2 cells, 3 channels, 9 orientations


def render_hog(hog_cells: np.ndarray, cell_px: int = 8) -> np.ndarray:
    """Draw each cell's 9-bin orientation histogram as oriented line segments
    (skimage-hog-style visualization). hog_cells: (H, W, 9) -> (H*c, W*c)."""
    gh, gw, n_orient = hog_cells.shape
    img = np.zeros((gh * cell_px, gw * cell_px), np.float32)
    r = cell_px // 2 - 1
    cy, cx = np.mgrid[0:cell_px, 0:cell_px]
    for o in range(n_orient):
        # skimage hog bins span [0, pi); bin centers at (o + .5) * pi / 9
        ang = (o + 0.5) * np.pi / n_orient
        dy, dx = np.sin(ang), np.cos(ang)
        # line mask inside the cell: |perp distance| < 0.7, |along| <= r
        py, px = cy - cell_px / 2 + 0.5, cx - cell_px / 2 + 0.5
        along = py * dy + px * dx
        perp = py * dx - px * dy
        line = ((np.abs(perp) < 0.7) & (np.abs(along) <= r)).astype(np.float32)
        img += np.kron(hog_cells[:, :, o], np.ones((cell_px, cell_px))) * \
            np.tile(line, (gh, gw))
    m = img.max()
    return img / m if m > 0 else img


def load_video(args, rng):
    """Decode ``args.video``: a temporal window drawn from ``rng``,
    ``num_frames`` frames spread over it from frame 0, Resize(-1, 1.15 S)
    -> CenterCrop(S) -> (the clip before Normalize (T, C, S, S) in 0..255,
    the normalised clip), float32."""
    reader = DecordInit()(args.video)
    try:
        start, end = T.temporal_window(
            len(reader), args.num_frames * args.frame_interval, rng)
        indices = np.linspace(0, max(end - start - 1, 0), args.num_frames,
                              dtype=int)
        video = reader.get_batch(indices).astype(np.float32)  # (T, H, W, C)
    finally:
        reader.close()
    pre = T.Compose([
        T.Resize(scale_range=(-1, int(args.image_size * 1.15))),
        T.CenterCrop(args.image_size)])
    pre.randomize_parameters()
    unnorm = pre(video.transpose(0, 3, 1, 2))
    post = T.Compose([T.ToTensor(), T.Normalize(list(MEAN), list(STD))])
    post.randomize_parameters()
    return unnorm, post(unnorm)


def draw_mask(args, rng):
    """The cube mask (T / 2, S / 16, S / 16) int32 and its cube markers
    [[start, span], ...] from ``rng``. The reference's ratio is 0.4; at
    fewer than 16 frames int(T' · 0.4) would give no cube, so 0.5 there."""
    grid = args.image_size // 16  # patch 4 x pooling 4: 16 px a token
    ratio = 0.4 if args.num_frames >= 16 else 0.5
    return CubeMaskGenerator(
        input_size=(args.num_frames // 2, grid, grid), mask_ratio=ratio,
        min_num_patches=4, rng=rng)()


def build_model(args):
    """MaskFeat with the trainer's two q-pool stages (model_trainer.py:54)
    and the default dim/head multipliers cut to ``args.depth``, the JAX
    package's initialisation from seed 0, then ``args.pretrained`` where
    given (``init_maskfeat_from_kinetics_pretrain``)."""
    muls = tuple((i, m) for i, m in ((1, 2.0), (3, 2.0), (14, 2.0))
                 if i < args.depth)
    model = MaskFeat(img_size=args.image_size, num_frames=args.num_frames,
                     pool_q_stride_size=((1, 1, 2, 2), (3, 1, 2, 2)),
                     embed_dim_mul=muls, atten_head_mul=muls,
                     feature_dim=2 * HOG_DIM, depth=args.depth,
                     patch_embed_dim=args.patch_embed_dim)
    model.reset_parameters(torch.Generator().manual_seed(0))
    if args.pretrained:
        convert.init_maskfeat_from_kinetics_pretrain(
            model, convert.read_checkpoint(args.pretrained))
    return model


def cube_centers(cube_marker):
    return [s * 2 + span * 2 // 2 for s, span in cube_marker]


@torch.inference_mode()
def maskfeat_arrays(model, unnorm, norm_video, mask, cube_marker):
    """``model``'s ``visualize=True`` forward (eval mode, its device and
    dtype) on one clip, with the HOG targets of ``unnorm`` (T, C, S, S)
    computed on the device at the cube centres and scattered into (1, T,
    S / 16, S / 16, 108): {"preds", "loss", "mask16", "hog_preds",
    "target"} as float32 numpy arrays."""
    p = next(model.parameters())
    dev = p.device
    markers, counts = pad_cube_marker([cube_marker], 8)
    centers = cube_centers(cube_marker)
    frames = torch.from_numpy(np.ascontiguousarray(
        unnorm.transpose(0, 2, 3, 1)))[None].to(dev)  # (1, T, H, W, C)
    hog = batched_hog_targets(frames[:, centers])
    grid = unnorm.shape[-1] // 16
    target = torch.zeros((1, unnorm.shape[0], grid, grid, 4 * 3 * 9),
                         device=dev)
    target[0, centers] = hog[0]
    out = model(torch.from_numpy(norm_video)[None].to(dev, p.dtype), target,
                torch.from_numpy(mask[None].astype(np.int32)).to(dev),
                torch.from_numpy(markers).to(dev),
                torch.from_numpy(counts).to(dev), visualize=True)
    names = ("preds", "loss", "mask16", "hog_preds")
    arrays = {n: t.float().cpu().numpy() for n, t in zip(names, out)}
    arrays["target"] = target.cpu().numpy()
    return arrays


def render(unnorm, arrays, cube_marker, args):
    """The render stage: hog_pred.png, real_img.png and mask_img.png at
    the first cube's centre frame into ``args.output_dir``; returns their
    paths."""
    from PIL import Image

    center = cube_centers(cube_marker)[0]
    grid = args.image_size // 16
    os.makedirs(args.output_dir, exist_ok=True)
    paths = [os.path.join(args.output_dir, n)
             for n in ("hog_pred.png", "real_img.png", "mask_img.png")]
    # (1) predicted HOG map at the center frame (channel-summed)
    hp = arrays["hog_preds"][0, center].sum(axis=-2)  # (2g, 2g, 9)
    hog_img = render_hog(hp, cell_px=args.image_size // (2 * grid))
    Image.fromarray((hog_img * 255).astype(np.uint8)).save(paths[0])
    # (2) the original center frame
    real = unnorm[center].transpose(1, 2, 0).astype(np.uint8)
    Image.fromarray(real).save(paths[1])
    # (3) the masked center frame (mask16 upsampled to pixels, blanked)
    m = arrays["mask16"][0, center]
    px = args.image_size // grid
    m_up = np.kron(m, np.ones((px, px)))[..., None]
    Image.fromarray((real * (1 - m_up)).astype(np.uint8)).save(paths[2])
    return paths


def run(args):
    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    unnorm, norm_video = load_video(args, rng)
    mask, cube_marker = draw_mask(args, rng)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = build_model(args).to(device, dtype).eval()
    arrays = maskfeat_arrays(model, unnorm, norm_video, mask, cube_marker)
    print(f"loss={float(arrays['loss']):.4f} "
          f"hog_preds={arrays['hog_preds'].shape}")
    render(unnorm, arrays, cube_marker, args)
    print(f"saved hog_pred/real_img/mask_img to {args.output_dir}")
    return arrays


def parse_args(argv=None):
    p = argparse.ArgumentParser("MaskFeat HOG-prediction visualization")
    p.add_argument("--video", default=BUNDLED_DEMO)
    p.add_argument("--pretrained", default="", type=str)
    p.add_argument("--output_dir", default="./maskfeat_vis")
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--frame_interval", type=int, default=2)
    p.add_argument("--depth", type=int, default=16)
    p.add_argument("--patch_embed_dim", type=int, default=96)
    p.add_argument("--seed", type=int, default=0,
                   help="the temporal window's and the cube mask's draws")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
