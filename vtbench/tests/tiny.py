"""A checkout of the benchmark at tiny sizes, for the tests on the CPU.

``make_root`` copies the benchmark's data files (configurations, mixes,
limits, metric readers, model adapters) into a directory and adds tiny configurations and
cells beside them, without touching the real ones: the harness finds the
tiny pieces by name, as a later change would add its own. ``prepare``
points the harness at the CPU and the trainer's ``build_model`` at the
tiny geometry; it is importable, so the data-parallel rehearsal's spawned
ranks run it too."""

import json
import os
import shutil

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TSF = dict(num_frames=2, img_size=32, embed_dims=64, num_heads=4,
           num_transformer_layers=2, num_class=10, raw_hw=[36, 48])
MVIT = dict(num_frames=8, img_size=64, depth=4, patch_embed_dim=32,
            raw_hw=[72, 96], embed_dim_mul=[[1, 2.0], [3, 2.0]],
            atten_head_mul=[[1, 2.0], [3, 2.0]])
LIMITS = {"loss": 1e-2, "grad": 1e-1, "change": 1e-1}


def _dump(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def _read(path):
    with open(path) as f:
        return json.load(f)


def make_root(root):
    """The tiny checkout under ``root``: cells tiny.train, tiny.serve,
    tiny.mim and tiny.dp (4 ranks)."""
    vt = os.path.join(root, "vtbench")
    os.makedirs(vt, exist_ok=True)
    for d in ("metrics", "traffic", "configs", "limits", "models"):
        shutil.copytree(os.path.join(REPO, "vtbench", d),
                        os.path.join(vt, d), dirs_exist_ok=True)
    conf = lambda n: _read(os.path.join(REPO, "vtbench", "configs", n))
    tsf = conf("timesformer_b16_divst_8x224.json")
    tsf.update(name="tiny_tsf", **TSF)
    tsf["trainer"].update(num_class=10, num_frames=2, img_size=32)
    mvit = conf("mvit_b_maskfeat_16x224.json")
    mvit.update(name="tiny_mvit", **MVIT)
    mvit["trainer"].update(num_frames=8, img_size=64)
    for c in (tsf, mvit):
        _dump(os.path.join(vt, "configs", c["name"] + ".json"), c)
    traffic = lambda n: _read(os.path.join(vt, "traffic", n + ".json"))
    small = dict(clips_per_step=4, trace_steps=2, warmup_steps=1,
                 reference_chunk=2)
    _dump(os.path.join(vt, "traffic", "tiny.train.json"),
          dict(traffic("finetune.b32"), **small))
    _dump(os.path.join(vt, "traffic", "tiny.mim.json"),
          dict(traffic("maskfeat.b32"), **small))
    _dump(os.path.join(vt, "traffic", "tiny.serve.json"),
          dict(traffic("serve.poisson"), rate=20.0, pool_clips=8, sample=4,
               trace_seconds=1, drain_s=30))
    bench = _read(os.path.join(REPO, "BENCHMARK.json"))
    cells = {"tiny.train": ("tiny_tsf", "tiny.train", 1, "finetune"),
             "tiny.dp": ("tiny_tsf", "tiny.train", 4, "finetune"),
             "tiny.mim": ("tiny_mvit", "tiny.mim", 1, "pretrain"),
             "tiny.serve": ("tiny_tsf", "tiny.serve", 1, "serve")}
    for name in ("tiny_tsf", "tiny_mvit"):
        bench["configs"].append({"name": name, "source": "tests",
                                 "file": f"vtbench/configs/{name}.json",
                                 "reduced": [], "why": "tests"})
    for cell, (conf_name, mix, chips, kind) in cells.items():
        bench["workloads"].append({"name": cell, "config": conf_name,
                                   "traffic": mix, "chips": chips,
                                   "why": "tests"})
        like = {"finetune": "tsf_b.finetune.b32" if chips == 1
                else "tsf_b.finetune.dp4", "pretrain": "mvit_b.maskfeat.b32",
                "serve": "tsf_b.serve.poisson"}[kind]
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
        _dump(os.path.join(vt, "limits", cell + ".json"),
              {"logits": 5e-2} if kind == "serve" else LIMITS)
    _dump(os.path.join(root, "BENCHMARK.json"), bench)
    return root


def tiny_model(c, mesh=None):
    from videotransformer_tpu_torch.models.maskfeat import MaskFeat
    from videotransformer_tpu_torch.models.timesformer import TimeSformer

    if c.objective == "mim":
        return MaskFeat(img_size=64, num_frames=8, patch_embed_dim=32,
                        depth=4, embed_dim_mul=((1, 2.0), (3, 2.0)),
                        atten_head_mul=((1, 2.0), (3, 2.0)),
                        pool_q_stride_size=((1, 1, 2, 2), (3, 1, 2, 2)),
                        feature_dim=216, mesh=mesh)
    return TimeSformer(num_frames=c.num_frames, img_size=c.img_size,
                       embed_dims=64, num_heads=4, num_transformer_layers=2,
                       attention_type=c.attention_type, mesh=mesh)


def prepare():
    """Run the harness on the CPU with the tiny models (tests only)."""
    from videotransformer_tpu_torch.training import trainer as trainer_mod
    from vtbench import devices

    devices.card = lambda rank=0: torch.device("cpu")
    devices.require = lambda chips: None
    trainer_mod.build_model = tiny_model
    torch.set_num_threads(1)


def prepare_no_exchange():
    """``prepare``, and the fault of a data-parallel step whose gradient
    exchange is left out: each rank steps on its own gradients."""
    from videotransformer_tpu_torch.training import optimizer

    prepare()
    optimizer.all_reduce_coalesced = lambda tensors, group: None
