"""Pipelined training runs of the port against one process, on the CPU:
tools/mp_train_worker.py over gloo processes (the ``JAX_``/``XLA_``
environment stripped, each run with its own timeout, its process group
killed when it expires), held against the worker's ``run`` in this
process on the global batch at tests/test_torch_parallel_mp.py's bounds
(loss 1e-5 and grad norm 1e-3 at every step, top-k equal, the parameters
of rank 0's gathered checkpoints rtol 1e-4 / atol 1e-6 after the first
step and 5e-4 / 5e-5 after the last):

- PP = 2 over the tiny TimeSformer's two layers with mixup and DropPath
  0.1 (layer 1 at 0.1 on stage 1: its draws are the one process's rows of
  the global draw, which stage 1 reaches by drawing layer 0's too), three
  steps and the fit over 5 eval clips in batches of 2, whose last batch has
  fewer rows than microbatches (a microbatch of no rows, skipped on both
  stages);
- DP = 2 x PP = 2 under torchrun (the eval shards uneven, 3 and 2 clips,
  the short rank padded); PP = 2 at ``--pp_microbatch 4`` (one row a
  microbatch); PP = 4 over 4 layers; PP = 2 with every block checkpointed
  (``--remat``, against the one process without it); TimeSformer
  space-only (a clip's frames spread over microbatches, put together for
  the frame mean); ViViT joint and divided (4 frames, tube 2);
- the CLI under torchrun with ``-pp 2`` over the demo clips, its gathered
  checkpoint loaded by a one-process trainer.

A stage sums each weight gradient over its microbatches, one process over
the batch at once, so the gradients part by fp32 rounding. AdamW's first
step moves an element by lr · g / (|g| + 1e-8): where |g| is near that
eps the step follows the rounding. At PP = 4 (four microbatches of one
row) four elements outside the key biases part beyond 1e-4 / 1e-6 after
the first step, by up to 2.2e-6 (measured; each |g| 1.2e-8 to 8.7e-8,
against a median |g| of its tensor of 4e-4 to 1.6e-3), so that run's
first step is held as test_torch_parallel_mp.py holds ViViT's, at 5e-4 /
5e-5 (its loss and grad norm at every step and its last step's
parameters are held as the others are). A stage-sum fault is of the
gradient's size, not eps's.
"""

import pytest

from videotransformer_tpu_torch import model_pretrain as pcli
from videotransformer_tpu_torch.training import trainer as ptrainer

import test_torch_parallel_mp as mp

RUNS = {  # (launcher, world, the worker's flags, _check's keywords)
    "pp2": ("spawn", 2, ["--pp", "2"], {}),
    "dp2-pp2": ("torchrun", 4, ["--pp", "2"], {"data": 2}),
    "pp2-m4": ("spawn", 2, ["--pp", "2", "--pp_microbatch", "4"], {}),
    # AdamW's first step on gradients near its eps (module doc)
    "pp4": ("spawn", 4, ["--pp", "4", "--layers", "4"],
            {"first": (5e-4, 5e-5)}),
    "pp2-remat": ("spawn", 2, ["--pp", "2", "--remat"], {}),
    "space-only-pp2": ("spawn", 2, ["--pp", "2", "--attention_type",
                                    "space_only"], {}),
    "vivit-joint-pp2": ("spawn", 2, ["--pp", "2", "--arch", "vivit",
                                     "--attention_type", "joint_space_time"],
                        {}),
    "vivit-divided-pp2": ("spawn", 2, ["--pp", "2", "--arch", "vivit",
                                       "--attention_type",
                                       "divided_space_time"], {}),
}
# the flags of the model, which the one process runs too
MODEL_FLAGS = ("--layers", "--arch", "--attention_type")


@pytest.mark.parametrize("what", list(RUNS))
def test_pp_run_matches_one_process(tmp_path, what):
    launcher, world, flags, keywords = RUNS[what]
    ckpt = str(tmp_path / "ckpt")
    one = list(mp.SUPERVISED)
    for i, flag in enumerate(flags):
        if flag in MODEL_FLAGS:
            one += flags[i:i + 2]
    run = mp._spawn if launcher == "spawn" else mp._torchrun
    outs = run(tmp_path, world, mp.SUPERVISED + flags + ["--ckpt", ckpt])
    mp._check(outs, one, ckpt, **keywords)


def test_cli_pp2_under_torchrun(tmp_path, monkeypatch):
    """``-pp 2`` under torchrun: the CLI builds the (data 1, pipe 2) mesh
    and the pipeline trainer, scales the LR by the data ranks' batch
    alone, trains an epoch over the demo clips, validates and tests, and
    writes a gathered checkpoint that a one-process trainer loads. The
    CLI's TimeSformer is cut to mp.CLI_TIMESFORMER's size (two blocks: one
    a stage)."""
    demo = f"{mp.REPO}/videotransformer_tpu/data/assets/demo"
    argv = ["-epoch", "1", "-batch_size", "4", "-num_class", "4",
            "-num_frames", "4", "-frame_interval", "4", "-img_size", "32",
            "-objective", "supervised", "-arch", "timesformer", "-lr",
            "0.005", "-root_dir", str(tmp_path), "-log_interval", "1",
            "-train_data_path", f"{demo}/demo_train_list.txt",
            "-val_data_path", f"{demo}/demo_train_list.txt",
            "-test_data_path", f"{demo}/demo_train_list.txt",
            "-classmap_path", f"{demo}/demo_classmap.json", "-use_fp16",
            "False"]
    out = mp.cli_under_torchrun(tmp_path, ["-pp", "2", *argv])
    assert "pp=2" in out and "lr=7.8125e-05" in out, out[-3000:]
    assert sum(ln.startswith("epoch 0 step") for ln in out.splitlines()) \
        == 3, out[-3000:]  # 12 demo clips in batches of 4
    for what in ("validation", "test"):
        assert f"of current {what} epoch" in out, out[-3000:]
    (ckpt,) = list(tmp_path.glob("results/*/ckpt/last_checkpoint"))
    mp.cli_sized_trainers(monkeypatch)
    cfg = pcli.parse_args(argv)
    tr = ptrainer.VideoTransformerTrainer(cfg, "cpu")
    tr.load_checkpoint(str(ckpt))
    assert tr.global_step == 3
