"""Export a trained model as a serving artifact of the port.

Port of ``videotransformer_tpu/tools/export_serving.py``: load weights (a
``.pth`` of the original repo through the Kinetics import, or a checkpoint
of the port's trainer), build the inference model, and write the artifact
directory (``serving/export.py``: a ``predict_b{B}.pt2`` program for each
bucket, ``params.npz`` and ``manifest.json``) that
``python -m videotransformer_tpu_torch.serving.server --export_dir`` serves.

    python -m videotransformer_tpu_torch.tools.export_serving \\
        --out ARTIFACT --arch timesformer --ckpt K400.pth \\
        [--ckpt_format torch|port] [--num_frames 8] [--num_class 400] \\
        [--img_size 224] [--buckets 1,2,4,8] [--input_mode clips|raw] \\
        [--dtype bfloat16|float32]

As in the JAX tool, the model is built at 224 whatever ``--img_size`` says:
at ``--img_size 448`` the artifact serves 448² crops with the 224 position
table resized on every forward. Without ``--ckpt`` the weights are the JAX
package's initialisation from seed 0 (a smoke export). ``--dtype`` is the
programs' working type (the head runs in fp32 either way). Runs on the
CPU, no card needed;
the programs serve on the CPU and on the card with the torch version that
traced them.
"""

import argparse

import torch

from videotransformer_tpu_torch.models.convert import read_checkpoint
from videotransformer_tpu_torch.ops.blocks import ClassificationHead
from videotransformer_tpu_torch.serving.export import export_predictor
from videotransformer_tpu_torch.tools.demo_inference import (
    build_model, init_model_and_head, load_kinetics_checkpoint)


def load_weights(args, model, head):
    """``--ckpt`` into the model and head: ``torch``, the Kinetics import
    (the head from its ``cls_head.*`` keys); ``port``, the port trainer's
    checkpoint, loaded strictly (the JAX tool's orbax train state)."""
    if args.ckpt is None:
        return
    if args.ckpt_format == "torch":
        load_kinetics_checkpoint(model, head, args.ckpt)
        return
    payload = read_checkpoint(args.ckpt)
    model.load_state_dict(payload["model"], strict=True)
    if payload.get("cls_head") is not None:
        head.load_state_dict(payload["cls_head"], strict=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--arch", default="timesformer",
                   choices=["timesformer", "vivit"])
    p.add_argument("--attention_type", default=None)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--ckpt_format", default="torch",
                   choices=["torch", "port"])
    p.add_argument("--num_frames", type=int, default=8)
    p.add_argument("--num_class", type=int, default=400)
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--n_crops", type=int, default=3)
    p.add_argument("--buckets", default="1,2,4,8")
    p.add_argument("--input_mode", default="clips", choices=["clips", "raw"],
                   help="'raw' ships canonical uint8 clips and runs the eval "
                        "preprocessing on the device")
    p.add_argument("--raw_hw", type=int, nargs=2, default=[256, 342],
                   help="canonical raw-clip (height, width) for --input_mode "
                        "raw")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="the programs' working type")
    args = p.parse_args(argv)

    model = build_model(args.arch, args.num_frames, args.attention_type)
    head = ClassificationHead(args.num_class, model.cls_token.shape[-1])
    init_model_and_head(model, head)
    load_weights(args, model, head)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    export_predictor(
        args.out, model, head, num_frames=args.num_frames,
        num_class=args.num_class, img_size=args.img_size,
        n_crops=args.n_crops, buckets=buckets, input_mode=args.input_mode,
        raw_hw=tuple(args.raw_hw), dtype=getattr(torch, args.dtype))
    print(f"wrote serving artifact to {args.out} (buckets {list(buckets)}, "
          f"input_mode {args.input_mode}, {args.dtype} programs)")


if __name__ == "__main__":
    main()
