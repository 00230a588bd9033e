"""Sequence parallelism of the port (``parallel/sp.py``, the seq axis of
``parallel/mesh.py``) on the CPU:

- the mesh's (data, seq, model) rank order, groups and DropPath's row cut
  against the global draw, in one process;
- against JAX: the tiny TimeSformer of tests/test_sequence_parallel.py:
  164-192 (width 32, 4 heads, 2 layers, 2 frames at 32²), its divided
  forward with sequence parallelism on over a (data 2, seq 2) mesh and the
  Pallas kernels in interpret mode, run here by JAX, and by the port over
  four gloo worker processes (the ``JAX_``/``XLA_`` environment stripped)
  from the same weights (the converter's names), each rank's features
  against JAX's rows: rtol 5e-4, atol 5e-5, as that test holds them;
- against one process: tools/mp_train_worker.py over SP = 2 (mixup and
  DropPath 0.1: the temporal rows' draws cut by (clip, patch), the
  spatial rows' by (clip, frame)), DP = 2 x SP = 2 under torchrun, SP = 2
  x TP = 2, SP = 2 with every block checkpointed (the backward's second
  forward runs the all-to-alls again), ViViT fact_encoder over SP = 2 (its
  spatial stack over frames, the temporal stack's cls rows the ``x[:b,
  0]`` rows gathered from the ranks that hold them) and a MaskFeat step
  over SP = 2 (the seq ranks are replicas), each held against the
  worker's run in one process at tests/test_torch_parallel_mp.py's bounds
  and with its exceptions (ViViT after its first step, SGD for MaskFeat).
  The parameters are held after the first step, so a cls row's gradient
  counted once a seq rank would fail: the loss is right whatever the
  backward does;
- the CLI under torchrun with ``-sp 2`` over the demo clips, its gathered
  checkpoint loaded by a one-process trainer.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videotransformer_tpu import config as jconfig
from videotransformer_tpu.models import TimeSformer as JTimeSformer
from videotransformer_tpu.models import convert as jconvert
from videotransformer_tpu.parallel import sp as jsp
from videotransformer_tpu.parallel.mesh import create_mesh as jcreate_mesh
from videotransformer_tpu_torch import model_pretrain as pcli
from videotransformer_tpu_torch.models.timesformer import TimeSformer
from videotransformer_tpu_torch.parallel import mesh as pmesh
from videotransformer_tpu_torch.training import trainer as ptrainer

import test_torch_parallel_mp as mp

TINY = dict(img_size=32, patch_size=16, embed_dims=64, num_heads=4,
            num_transformer_layers=2)


def _shape_mesh(data, seq, model, rank):
    """A mesh that only places a rank (no process group behind it)."""
    return pmesh.Mesh(data, model, rank, None, None, seq=seq)


def test_mesh_orders_ranks_as_jax():
    """Global rank (d · seq + s) · model + m: JAX's (data, seq, model)
    order, model fastest; each group's ranks at the others' fixed."""
    for rank in range(12):
        m = _shape_mesh(2, 3, 2, rank)
        d, s, r = m.data_rank, m.seq_rank, m.model_rank
        assert (d * 3 + s) * 2 + r == rank
        assert m.seq_ranks == [(d * 3 + k) * 2 + r for k in range(3)]
        assert m.data_ranks == [(k * 3 + s) * 2 + r for k in range(2)]
        assert m.model_ranks == [(d * 3 + s) * 2 + k for k in range(2)]
    grid = np.arange(12).reshape(2, 3, 2)  # JAX's mesh of devices
    m = _shape_mesh(2, 3, 2, 9)
    assert grid[m.data_rank, m.seq_rank, m.model_rank] == 9


@pytest.mark.parametrize("data,seq", [(1, 2), (2, 2), (3, 2), (1, 4)])
def test_drop_path_rows_are_the_global_draws(data, seq):
    """Every rank draws the global tensor and keeps its (clip, k) rows:
    this data rank's clips and this seq rank's k, which are not a
    contiguous slice of the flat draw; per-clip rows are the same on every
    seq rank."""
    clips, k = 3, 4 * seq
    want = torch.rand((data * clips * k, 1, 1),
                      generator=torch.Generator().manual_seed(5))
    want = want.reshape(data, clips, k)
    per_clip = torch.rand((data * clips, 1),
                          generator=torch.Generator().manual_seed(5))
    for rank in range(data * seq):
        m = _shape_mesh(data, seq, 1, rank)
        got = pmesh.rand_rows((clips * (k // seq), 1, 1),
                              torch.Generator().manual_seed(5), torch.float32,
                              "cpu", m, clips=clips)
        ks = slice(m.seq_rank * (k // seq), (m.seq_rank + 1) * (k // seq))
        assert torch.equal(got.reshape(clips, -1),
                           want[m.data_rank, :, ks])
        got = pmesh.rand_rows((clips, 1), torch.Generator().manual_seed(5),
                              torch.float32, "cpu", m)
        assert torch.equal(got, per_clip[m.data_rank * clips:
                                         (m.data_rank + 1) * clips])


def test_model_refuses_a_seq_that_does_not_split_it():
    with pytest.raises(ValueError, match="does not divide the 4 patches"):
        TimeSformer(num_frames=3, **TINY, mesh=_shape_mesh(1, 3, 1, 0))
    with pytest.raises(ValueError, match="does not divide the 3 frames"):
        TimeSformer(num_frames=3, **TINY, mesh=_shape_mesh(1, 2, 1, 0))
    # joint attention splits the patches only; space-only the frames only
    TimeSformer(num_frames=3, **TINY, attention_type="joint_space_time",
                mesh=_shape_mesh(1, 2, 1, 0))
    TimeSformer(num_frames=2, **TINY, attention_type="space_only",
                mesh=_shape_mesh(1, 2, 1, 0))


# ------------------------------------------------------- against JAX

# one rank: the port's forward over (data 2, seq 2) from JAX's weights
FORWARD_RANK = """
import sys, numpy as np, torch
from videotransformer_tpu_torch.models.timesformer import TimeSformer
from videotransformer_tpu_torch.parallel import mesh
rank, store, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
mesh.init_distributed("gloo", store, rank, 4, "cpu")
m = mesh.create_mesh(seq=2)
state = np.load(f"{d}/state.npz")
model = TimeSformer(num_frames=2, img_size=32, patch_size=16, embed_dims=32,
                    num_heads=4, num_transformer_layers=2, mesh=m)
model.load_state_dict({k: torch.from_numpy(state[k]) for k in state.files},
                      strict=True)
video = torch.from_numpy(np.load(f"{d}/video.npy"))
rows = video.shape[0] // m.data
with torch.no_grad():
    out = model.eval()(video[m.data_rank * rows:(m.data_rank + 1) * rows])
np.save(f"{d}/out{rank}.npy", out.numpy())
torch.distributed.destroy_process_group()
print("WORKER OK", flush=True)
"""


def test_sp_forward_matches_jax_sp_forward(tmp_path):
    model = JTimeSformer(num_frames=2, img_size=32, patch_size=16,
                         embed_dims=32, num_heads=4, num_transformer_layers=2,
                         attention_type="divided_space_time")
    rng = np.random.RandomState(0)
    video = rng.rand(4, 2, 3, 32, 32).astype(np.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.asarray(video))["params"]
    mesh = jcreate_mesh(data=2, seq=2, model=1, devices=jax.devices()[:4])
    from jax.experimental.pallas import tpu as pltpu
    jconfig.set_attention_backend("pallas")
    try:
        with jsp.sequence_parallel(mesh):
            with pltpu.force_tpu_interpret_mode():
                want = np.asarray(jax.jit(lambda p, v: model.apply(
                    {"params": p}, v))(params, jnp.asarray(video)))
    finally:
        jconfig.set_attention_backend("auto")
    state = jconvert.flax_to_torch_state_dict(jax.device_get(params))
    np.savez(tmp_path / "state.npz", **{k: np.asarray(v, np.float32)
                                         for k, v in state.items()})
    np.save(tmp_path / "video.npy", video)
    store = f"file://{tmp_path}/store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", FORWARD_RANK, str(r), store, str(tmp_path)],
        cwd=mp.REPO, env=mp._env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
        for r in range(4)]
    for out in mp._communicate(procs):
        assert "WORKER OK" in out, out[-3000:]
    for rank in range(4):
        data_rank = rank // 2  # both seq ranks hold the cls readout
        got = np.load(tmp_path / f"out{rank}.npy")
        np.testing.assert_allclose(got, want[2 * data_rank:2 * data_rank + 2],
                                   rtol=5e-4, atol=5e-5)


# ------------------------------------------------------- one process

RUNS = {  # (launcher, world, the worker's flags, _check's keywords)
    "sp2": ("spawn", 2, ["--sp", "2"], {}),
    "dp2-sp2": ("torchrun", 4, ["--sp", "2"], {"data": 2}),
    "sp2-tp2": ("spawn", 4, ["--sp", "2", "--tp", "2"], {}),
    "sp2-remat": ("spawn", 2, ["--sp", "2", "--remat"], {}),
    "vivit-fact-sp2": ("spawn", 2, ["--sp", "2", "--arch", "vivit",
                                    "--attention_type", "fact_encoder"],
                       {"first": (5e-4, 5e-5)}),
}


@pytest.mark.parametrize("what", list(RUNS))
def test_sp_run_matches_one_process(tmp_path, what):
    launcher, world, flags, keywords = RUNS[what]
    ckpt = str(tmp_path / "ckpt")
    # the one process runs the model's flags alone (without remat)
    argv = mp.SUPERVISED + flags[flags.index("--arch"):] \
        if "--arch" in flags else mp.SUPERVISED
    run = mp._spawn if launcher == "spawn" else mp._torchrun
    outs = run(tmp_path, world, mp.SUPERVISED + flags + ["--ckpt", ckpt])
    mp._check(outs, argv, ckpt, **keywords)


def test_mim_sp2_seq_ranks_are_replicas(tmp_path):
    argv = mp.TINY_CPU + ["--objective", "mim", "--steps", "1", "--optim",
                          "sgd"]
    ckpt = str(tmp_path / "ckpt")
    outs = mp._spawn(tmp_path, 2, argv + ["--sp", "2", "--ckpt", ckpt])
    mp._check(outs, argv, ckpt, adamw=False)


def test_cli_sp2_under_torchrun(tmp_path, monkeypatch):
    """``-sp 2`` under torchrun: the CLI builds the (data 1, seq 2) mesh,
    scales the LR by the data ranks' batch alone, trains an epoch over the
    demo clips and writes a gathered checkpoint that a one-process trainer
    loads. The CLI's TimeSformer is cut to mp.CLI_TIMESFORMER's size."""
    demo = f"{mp.REPO}/videotransformer_tpu/data/assets/demo"
    argv = ["-epoch", "1", "-batch_size", "4", "-num_class", "4",
            "-num_frames", "4", "-frame_interval", "4", "-img_size", "32",
            "-objective", "supervised", "-arch", "timesformer", "-lr",
            "0.005", "-root_dir", str(tmp_path), "-log_interval", "1",
            "-train_data_path", f"{demo}/demo_train_list.txt",
            "-classmap_path", f"{demo}/demo_classmap.json", "-use_fp16",
            "False"]
    out = mp.cli_under_torchrun(tmp_path, ["-sp", "2", *argv])
    assert "sp=2" in out and "lr=7.8125e-05" in out, out[-3000:]
    assert sum(ln.startswith("epoch 0 step") for ln in out.splitlines()) \
        == 3, out[-3000:]  # 12 demo clips in batches of 4
    (ckpt,) = list(tmp_path.glob("results/*/ckpt/last_checkpoint"))
    mp.cli_sized_trainers(monkeypatch)
    cfg = pcli.parse_args(argv)
    tr = ptrainer.VideoTransformerTrainer(cfg, "cpu")
    tr.load_checkpoint(str(ckpt))
    assert tr.global_step == 3
