"""Synthesise the bundled demo clips with the port's encoder.

Twin of the repository's ``tools/make_demo_assets.py``: four visually
distinct motion classes (a horizontal and a vertical sliding bar, a pulsing
circle, a rotating checkerboard), three clips each of 40 frames at 192x256
and 25 fps, written by ``native/videoenc.py``; then the kinetics-format
list ``demo_train_list.txt`` and ``demo_classmap.json``. The frames come
from seeded numpy draws, so a run reproduces the same pixels, and the same
bytes as the JAX package's encoder against the same FFmpeg.

    python -m videotransformer_tpu_torch.tools.make_demo_assets OUT_DIR

The committed clips are in ``videotransformer_tpu/data/assets/demo/``;
this writes a fresh set to OUT_DIR. Needs g++ and FFmpeg's headers (host
only; no card).
"""

import argparse
import json
import os

import numpy as np

from videotransformer_tpu_torch.native.videoenc import write_video

T, H, W = 40, 192, 256
FPS = 25
CLASSES = ["bar_slide_h", "bar_slide_v", "pulse_circle", "checker_spin"]
SEEDS = 3


def _base(rng, h, w):
    """Low-frequency random background."""
    small = rng.rand(h // 16, w // 16, 3)
    big = np.kron(small, np.ones((16, 16, 1)))
    return (big * 80 + 60).astype(np.float32)


def make_clip(cls, seed):
    """The (T, H, W, 3) uint8 frames of class ``cls``'s clip ``seed``."""
    rng = np.random.RandomState(1000 * cls + seed)
    bg = _base(rng, H, W)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    speed = 3 + rng.randint(0, 4)
    phase = rng.randint(0, 64)
    frames = np.empty((T, H, W, 3), np.uint8)
    color = rng.rand(3) * 155 + 100
    for t in range(T):
        img = bg.copy()
        if cls == 0:  # horizontal sliding bar
            c = (phase + t * speed) % W
            m = np.abs(((x - c + W / 2) % W) - W / 2) < 14
        elif cls == 1:  # vertical sliding bar
            c = (phase + t * speed) % H
            m = np.abs(((y - c + H / 2) % H) - H / 2) < 14
        elif cls == 2:  # pulsing circle
            r = 20 + 30 * (0.5 + 0.5 * np.sin((t + phase) * 0.35))
            m = ((x - W / 2) ** 2 + (y - H / 2) ** 2) < r ** 2
        else:  # rotating checkerboard
            a = (t + phase) * 0.12
            u = np.cos(a) * (x - W / 2) + np.sin(a) * (y - H / 2)
            v = -np.sin(a) * (x - W / 2) + np.cos(a) * (y - H / 2)
            m = ((u // 24).astype(int) + (v // 24).astype(int)) % 2 == 0
        img[m] = color
        frames[t] = np.clip(img, 0, 255).astype(np.uint8)
    return frames


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out_dir")
    out_dir = p.parse_args(argv).out_dir
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for cls, name in enumerate(CLASSES):
        for seed in range(SEEDS):
            clip = f"{name}_{seed}.mp4"
            write_video(os.path.join(out_dir, clip), make_clip(cls, seed),
                        FPS)
            rows.append(f"{clip}\t{name}")
    with open(os.path.join(out_dir, "demo_train_list.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    with open(os.path.join(out_dir, "demo_classmap.json"), "w") as f:
        json.dump({c: str(i) for i, c in enumerate(CLASSES)}, f, indent=1)
    print(f"wrote {len(rows)} clips to {out_dir}")
    return rows


if __name__ == "__main__":
    main()
