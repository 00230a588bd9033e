"""Pipeline parallelism of the port (``parallel/pp.py``, the pipe axis of
``parallel/mesh.py``, ``training/stacked_trainer.py``,
``training/pp_trainer.py``, ``-pp`` in the CLI) on the CPU:

- the mesh's (data, seq, model, pipe) rank order against JAX's
  ``create_mesh(..., pipe=)`` device grid, pipe = 1 unchanged; the stage
  split of a state dict, and in two gloo ranks a stage's parameters and
  moments (its blocks' only), the gathered state bit-exact against one
  process's, and the stage move's two forms (broadcast and send/recv) on
  the same bits;
- against JAX: the tiny TimeSformer (4 layers, width 32, 4 heads, 2 frames
  at 32²) and ViViT divided (4 frames, tube 2) through the port's
  pipelined forward in two gloo ranks (M = 2) against JAX's
  ``pipelined_forward_features`` on a pipe = 2 mesh of the conftest's
  virtual devices, rtol 5e-4 / atol 5e-5 as test_torch_sequence_parallel.py
  holds its forward; one PP = 2 step (4 layers, width 64, no mixup,
  DropPath 0) against JAX's ``PipelineTrainer`` on ``create_mesh(data=1,
  pipe=2)``: loss and grad norm rtol 1e-4, the parameters at
  tests/test_pp_training.py's rtol 5e-4 / atol 1e-4;
- checkpoints: a PP = 2 run's gathered checkpoint into one process and
  back into PP = 2, every tensor bit-equal, moments and step included;
- the linear probe over PP = 2 (the head alone trains, on the last
  stage) against one process, to the bit;
- refusals as JAX's: MaskFeat, ``arch=mvit``, fact_encoder, ``-pp`` with
  ``-tp``/``-sp``, layers or rows that do not divide, in the trainer and
  in the CLI.

The worker runs against one process are in
tests/test_torch_pipeline_runs.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videotransformer_tpu.models import TimeSformer as JTimeSformer
from videotransformer_tpu.models import ViViT as JViViT
from videotransformer_tpu.models import convert as jconvert
from videotransformer_tpu.parallel import pp as jpp
from videotransformer_tpu.parallel.mesh import create_mesh as jcreate_mesh
from videotransformer_tpu.parallel.mesh import shard_batch as jshard_batch
from videotransformer_tpu.training import pp_trainer as jpp_trainer
from videotransformer_tpu.training import trainer as jtrainer
from videotransformer_tpu_torch import model_pretrain as pcli
from videotransformer_tpu_torch.models.convert import flatten_tree
from videotransformer_tpu_torch.models.timesformer import TimeSformer
from videotransformer_tpu_torch.parallel import mesh as pmesh
from videotransformer_tpu_torch.parallel import pp
from videotransformer_tpu_torch.tools import mp_train_worker as worker
from videotransformer_tpu_torch.training import pp_trainer
from videotransformer_tpu_torch.training import trainer as ptrainer

import test_torch_parallel_mp as mp

TINY_PP = ["--model", "tiny", "--device", "cpu", "--pp", "2", "--layers",
           "4", "--clips", "4"]


def _ranks(tmp_path, script, world, *extra):
    """``world`` ranks of ``script`` meeting in a FileStore; their
    stdouts, each checked for WORKER OK."""
    store = f"file://{tmp_path}/store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), store, str(tmp_path),
         *extra], cwd=mp.REPO, env=mp._env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
        for r in range(world)]
    outs = mp._communicate(procs)
    for out in outs:
        assert "WORKER OK" in out, out[-3000:]
    return outs


# ------------------------------------------------------------ the mesh

def test_mesh_orders_ranks_as_jax_with_pipe():
    """Global rank ((d · seq + s) · model + m) · pipe + p: JAX's (data,
    seq, model, pipe) device grid, pipe fastest; each group's ranks at the
    others' fixed."""
    data, seq, model, pipe = 2, 1, 2, 2
    grid = np.vectorize(lambda d: d.id)(jcreate_mesh(
        data=data, seq=seq, model=model, pipe=pipe,
        devices=jax.devices()[:8]).devices)
    for rank in range(8):
        m = pmesh.Mesh(data, model, rank, None, None, seq=seq, pipe=pipe)
        d, s, r, p = m.data_rank, m.seq_rank, m.model_rank, m.pipe_rank
        assert grid[d, s, r, p] == rank
        assert m.pipe_ranks == list(grid[d, s, r, :])
        assert m.data_ranks == list(grid[:, s, r, p])
        assert m.model_ranks == list(grid[d, s, :, p])
        assert m.seq_ranks == list(grid[d, :, r, p])
    # pipe = 1: JAX's three-axis mesh, and every rank as before the axis
    grid = np.vectorize(lambda d: d.id)(jcreate_mesh(
        data=2, seq=2, model=2, devices=jax.devices()[:8]).devices)
    for rank in range(8):
        m = pmesh.Mesh(2, 2, rank, None, None, seq=2)
        assert (m.pipe, m.pipe_rank, m.pipe_ranks) == (1, 0, [rank])
        assert grid[m.data_rank, m.seq_rank, m.model_rank] == rank
        assert m.data_ranks == list(grid[:, m.seq_rank, m.model_rank])


@pytest.mark.parametrize("stages", [2, 4])
def test_stage_state_dicts_split_the_state(stages):
    """Every key in exactly one stage: layer i's blocks in stage i // (L /
    P), the embedding in stage 0, the final norm in the last; put back
    together, the state as it was."""
    model = TimeSformer(num_frames=2, img_size=32, embed_dims=32,
                        num_heads=4, num_transformer_layers=4)
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = model.state_dict()
    parts = [pp.stage_state_dict(state, 4, stages, q) for q in range(stages)]
    assert sum(map(len, parts)) == len(state)
    back = {k: v for part in parts for k, v in part.items()}
    assert sorted(back) == sorted(state)
    assert all(back[k] is state[k] for k in state)
    per = 4 // stages
    for q, part in enumerate(parts):
        layers = {int(k.split(".")[2]) for k in part
                  if k.startswith(pp.LAYER_PREFIX)}
        assert layers == set(range(q * per, (q + 1) * per))
        assert ("cls_token" in part) == (q == 0)
        assert ("norm.weight" in part) == (q == stages - 1)


# one rank of the layout check: a PipelineTrainer's stage against the
# one-process trainer from the same seed, then the stage move's two forms
STAGE_RANK = """
import sys, torch
from videotransformer_tpu_torch.parallel import mesh, pp
from videotransformer_tpu_torch.tools import mp_train_worker as w
from videotransformer_tpu_torch.training import pp_trainer, trainer
rank, store = int(sys.argv[1]), sys.argv[2]
mesh.init_distributed("gloo", store, rank, 2, "cpu")
m = mesh.create_mesh(pipe=2)
args = w.parse_args(%r)
w.use_tiny_models("supervised", 4)
cfg = w.configs(args)
tr = pp_trainer.PipelineTrainer(cfg, "cpu", mesh=m)
one = trainer.VideoTransformerTrainer(cfg, "cpu")
full, head = one.model.state_dict(), one.cls_head.state_dict()
own = pp.stage_state_dict(full, 4, 2, rank)
local = tr.model.state_dict()
assert list(local) == list(own), (list(local), list(own))
assert all(torch.equal(local[k], v) for k, v in own.items())
layers = {int(k.split(".")[2]) for k in own if k.startswith(pp.LAYER_PREFIX)}
assert layers == {2 * rank, 2 * rank + 1}, layers
names = ["model." + k for k in own] + (
    ["cls_head." + k for k in head] if rank == 1 else [])
assert list(tr.optimizer.params) == names
assert list(tr.optimizer.mu) == names and list(tr.optimizer.nu) == names
assert (tr.cls_head is None) == (rank == 0)
got, got_head = tr.model_state_dict(), tr.head_state_dict()
assert list(got) == list(full) and list(got_head) == list(head)
assert all(torch.equal(got[k], full[k]) for k in full)
assert all(torch.equal(got_head[k], head[k]) for k in head)
x = torch.randn(3, 5, 8, generator=torch.Generator().manual_seed(3))
for nccl_form in (False, True):  # broadcast, then send/recv (gloo takes it)
    mesh.p2p_form = lambda group, f=nccl_form: f
    for dtype in (torch.float32, torch.bfloat16):
        y = x.to(dtype)
        if rank == 0:
            mesh.send_stage(y, m, 1)
            assert torch.equal(mesh.recv_stage(y.shape, dtype, m, 1), y * 2)
        else:
            got = mesh.recv_stage(y.shape, dtype, m, 0)
            assert torch.equal(got, y)
            mesh.send_stage(got * 2, m, 0)
torch.distributed.destroy_process_group()
print("WORKER OK", flush=True)
""" % (TINY_PP,)


def test_stage_holds_its_blocks_and_gathers_bit_exact(tmp_path):
    _ranks(tmp_path, STAGE_RANK, 2)


# ------------------------------------------------------------ against JAX

FORWARD_RANK = """
import sys, numpy as np, torch
from videotransformer_tpu_torch.models.timesformer import TimeSformer
from videotransformer_tpu_torch.models.vivit import ViViT
from videotransformer_tpu_torch.parallel import mesh, pp
rank, store, d, arch = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
mesh.init_distributed("gloo", store, rank, 2, "cpu")
m = mesh.create_mesh(pipe=2)
tiny = dict(img_size=32, patch_size=16, embed_dims=32, num_heads=4,
            num_transformer_layers=4)
model = ViViT(num_frames=4, tube_size=2, attention_type="divided_space_time",
              **tiny) if arch == "vivit" else TimeSformer(num_frames=2, **tiny)
state = np.load(f"{d}/state.npz")
model.load_state_dict({k: torch.from_numpy(state[k]) for k in state.files},
                      strict=True)
stage = pp.Stage(model, m)
out = pp.pipelined_forward_features(
    stage, torch.from_numpy(np.load(f"{d}/video.npy")), microbatches=2)
assert (out is None) == (rank == 0)
if out is not None:
    np.save(f"{d}/out.npy", out.numpy())
torch.distributed.destroy_process_group()
print("WORKER OK", flush=True)
"""


@pytest.mark.parametrize("arch", ["timesformer", "vivit"])
def test_pp_forward_matches_jax_pipelined_forward(tmp_path, arch):
    tiny = dict(img_size=32, patch_size=16, embed_dims=32, num_heads=4,
                num_transformer_layers=4, drop_path_rate=0.0)
    if arch == "vivit":  # its blocks see num_frames // tube_size frames
        model = JViViT(num_frames=4, tube_size=2,
                       attention_type="divided_space_time", **tiny)
    else:
        model = JTimeSformer(num_frames=2,
                             attention_type="divided_space_time", **tiny)
    rng = np.random.RandomState(0)
    video = rng.rand(4, model.num_frames, 3, 32, 32).astype(np.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.asarray(video))["params"]
    mesh = jcreate_mesh(data=1, pipe=2, devices=jax.devices()[:2])
    want = np.asarray(jpp.pipelined_forward_features(
        model, params, jnp.asarray(video), mesh, microbatches=2))
    state = jconvert.flax_to_torch_state_dict(jax.device_get(params))
    np.savez(tmp_path / "state.npz", **{k: np.asarray(v, np.float32)
                                         for k, v in state.items()})
    np.save(tmp_path / "video.npy", video)
    _ranks(tmp_path, FORWARD_RANK, 2, arch)
    got = np.load(tmp_path / "out.npy")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-5)


STEP_RANK = """
import sys, numpy as np, torch
from videotransformer_tpu_torch.models.convert import flatten_tree
from videotransformer_tpu_torch.models.convert import unflatten_tree
from videotransformer_tpu_torch.parallel import mesh
from videotransformer_tpu_torch.tools import mp_train_worker as w
rank, store, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
mesh.init_distributed("gloo", store, rank, 2, "cpu")
m = mesh.create_mesh(pipe=2)
args = w.parse_args(%r)
w.use_tiny_models("supervised", 4)
saved = np.load(f"{d}/params.npz")
tree = unflatten_tree({k.replace(":", "/"): saved[k] for k in saved.files})
tr = w.run(args, "cpu", m, out=lambda line: print(line, flush=True),
           params=tree)
got = flatten_tree(tr.params_tree())
if rank == 0:
    np.savez(f"{d}/got.npz",
             **{k.replace("/", ":"): v for k, v in got.items()})
torch.distributed.destroy_process_group()
print("WORKER OK", flush=True)
""" % (TINY_PP + ["--steps", "1", "--eval_clips", "0"],)


def test_pp_step_matches_jax_pipeline_trainer(monkeypatch, tmp_path):
    """One PP = 2 step of the port from JAX's initialisation against JAX's
    PipelineTrainer on a (data 1, pipe 2) mesh, the same batch."""
    args = worker.parse_args(TINY_PP + ["--steps", "1", "--eval_clips", "0"])
    cfg = worker.configs(args)
    monkeypatch.setattr(jtrainer, "build_model", lambda c: JTimeSformer(
        num_frames=2, img_size=32, patch_size=16, embed_dims=64,
        num_heads=4, num_transformer_layers=4, drop_path_rate=0.0,
        dtype=jtrainer.model_dtype(c)))
    jt = jpp_trainer.PipelineTrainer(cfg, ckpt_dir=None, mesh=jcreate_mesh(
        data=1, pipe=2, devices=jax.devices()[:2]))
    init = flatten_tree(jax.device_get(jt._canonical_params()))
    np.savez(tmp_path / "params.npz",
             **{k.replace("/", ":"): v for k, v in init.items()})
    batch = jshard_batch(jt.mesh, worker.global_batch(cfg, args.clips,
                                                       worker.SEED))
    jt.params, jt.opt_state, js = jt._train_step(
        jt.params, jt.opt_state, batch, jax.random.fold_in(jt.base_key, 0),
        jnp.float32(args.lr), jnp.float32(worker.WD))
    out = _ranks(tmp_path, STEP_RANK, 2)
    lines = [mp._parse(o)[0] for o in out]
    assert lines[0] == lines[1]  # both stages print the same
    ((loss, norm),) = mp._parse(out[0])[1]
    np.testing.assert_allclose(loss, float(js["loss"]), rtol=1e-4)
    np.testing.assert_allclose(norm, float(js["grad_norm"]), rtol=1e-4)
    want = flatten_tree(jax.device_get(jt._canonical_params()))
    saved = np.load(tmp_path / "got.npz")
    got = {k.replace(":", "/"): saved[k] for k in saved.files}
    assert sorted(got) == sorted(want)
    for k in want:  # tests/test_pp_training.py:63-77's bounds
        np.testing.assert_allclose(got[k], want[k], rtol=5e-4, atol=1e-4,
                                   err_msg=k)


# ------------------------------------------------------------ checkpoints

RELOAD_RANK = """
import sys, torch
from videotransformer_tpu_torch.parallel import mesh
from videotransformer_tpu_torch.tools import mp_train_worker as w
from videotransformer_tpu_torch.training import pp_trainer
rank, store, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
mesh.init_distributed("gloo", store, rank, 2, "cpu")
m = mesh.create_mesh(pipe=2)
w.use_tiny_models("supervised", 4)
tr = pp_trainer.PipelineTrainer(w.configs(w.parse_args(%r)), "cpu", mesh=m)
tr.load_checkpoint(f"{d}/one")
tr.save_checkpoint(f"{d}/back")
torch.distributed.destroy_process_group()
print("WORKER OK", flush=True)
""" % (TINY_PP,)


def _same_payload(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _same_payload(a[k], b[k])
        elif torch.is_tensor(a[k]):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_pp_checkpoint_interchanges_with_one_process(tmp_path):
    """A PP = 2 run's checkpoint (rank 0's, gathered) loads into a
    one-process trainer, whose own checkpoint loads into a PP = 2 trainer
    again: every parameter, moment and counter bit-equal throughout."""
    ckpt = str(tmp_path / "pp")
    mp._spawn(tmp_path, 2, TINY_PP + ["--steps", "1", "--eval_clips", "0",
                                      "--mixup", "--drop_path", "0.1",
                                      "--ckpt", ckpt])
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setattr(ptrainer, "build_model", ptrainer.build_model)
        worker.use_tiny_models("supervised", 4)
        one = ptrainer.VideoTransformerTrainer(
            worker.configs(worker.parse_args(TINY_PP)), "cpu")
    one.load_checkpoint(f"{ckpt}.0")
    assert one.global_step == 1 and one.optimizer.step_count == 1
    reload = tmp_path / "reload"  # a store of its own
    reload.mkdir()
    one.save_checkpoint(str(reload / "one"))
    _ranks(reload, RELOAD_RANK, 2)
    pp_file, one_file, back = (
        torch.load(p, weights_only=True) for p in
        (f"{ckpt}.0", reload / "one", reload / "back"))
    # a loaded trainer is in the epoch after the saved one, and saves that
    assert one.epoch == pp_file["epoch"] == one_file["epoch"] - 1
    assert back["epoch"] == one_file["epoch"] + 1
    for payload in (pp_file, one_file, back):
        payload.pop("epoch")
    _same_payload(pp_file, one_file)
    _same_payload(one_file, back)
    assert list(pp_file["model"]) == list(one.model.state_dict())
    assert list(pp_file["opt_state"]["mu"]) == list(one.optimizer.mu)


IMPORT_RANK = """
import sys, torch
from videotransformer_tpu_torch.parallel import mesh
from videotransformer_tpu_torch.tools import mp_train_worker as w
from videotransformer_tpu_torch.training import pp_trainer
rank, store, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
mesh.init_distributed("gloo", store, rank, 2, "cpu")
m = mesh.create_mesh(pipe=2)
w.use_tiny_models("supervised", 4)
tr = pp_trainer.PipelineTrainer(w.configs(w.parse_args(%r)), "cpu", mesh=m)
missing, unexpected = tr.import_pretrained(f"{d}/one")
assert not missing and not unexpected, (missing, unexpected)
tr.save_checkpoint(f"{d}/imported")
torch.distributed.destroy_process_group()
print("WORKER OK", flush=True)
""" % (TINY_PP,)


def test_pp_import_pretrained_takes_the_stage_slice(tmp_path):
    """``import_pretrained`` on a built PP = 2 trainer (its stages cut)
    goes through the whole model: a one-process checkpoint of other
    weights comes back from the gathered state bit-equal, the head left
    as the seed made it, as one process imports it."""
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setattr(ptrainer, "build_model", ptrainer.build_model)
        worker.use_tiny_models("supervised", 4)
        cfg = worker.configs(worker.parse_args(TINY_PP))
        other = ptrainer.VideoTransformerTrainer(cfg, "cpu", seed=7)
        fresh = ptrainer.VideoTransformerTrainer(cfg, "cpu")
    other.save_checkpoint(str(tmp_path / "one"))
    fresh.import_pretrained(str(tmp_path / "one"))
    _ranks(tmp_path, IMPORT_RANK, 2)
    got = torch.load(tmp_path / "imported", weights_only=True)
    want = other.model_state_dict()
    assert list(got["model"]) == list(want)
    for k, v in want.items():
        assert torch.equal(got["model"][k], v), k
        assert torch.equal(fresh.model.state_dict()[k], v), k
    for k, v in fresh.cls_head.state_dict().items():
        assert torch.equal(got["cls_head"][k], v), k


# the linear probe over PP = 2: the blocks run without grad, the last
# stage's head alone trains; stage 0's optimizer holds nothing
PROBE_RANK = """
import sys, torch
from videotransformer_tpu_torch.parallel import mesh
from videotransformer_tpu_torch.tools import mp_train_worker as w
from videotransformer_tpu_torch.training import pp_trainer
rank, store, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
mesh.init_distributed("gloo", store, rank, 2, "cpu")
m = mesh.create_mesh(pipe=2)
w.use_tiny_models("supervised", 4)
cfg = w.configs(w.parse_args(%r))
cfg.eval_metrics = "linear_prob"
tr = pp_trainer.PipelineTrainer(cfg, "cpu", mesh=m)
assert len(tr.optimizer.params) == (2 if rank == 1 else 0)
batch = {k: torch.from_numpy(v)
         for k, v in w.global_batch(cfg, 4, w.SEED).items()}
for i in range(2):
    s = tr.train_step(batch, 1e-3, w.WD)
    print("STEP", i, "loss", repr(float(s["loss"])), "grad_norm",
          repr(float(s["grad_norm"])), flush=True)
state = {"model": tr.model_state_dict(), "head": tr.head_state_dict()}
if rank == 0:
    torch.save(state, f"{d}/probe.pt")
torch.distributed.destroy_process_group()
print("WORKER OK", flush=True)
""" % (TINY_PP + ["--mixup"],)


def test_linear_probe_trains_the_head_alone(tmp_path):
    """``eval_metrics=linear_prob`` under PP = 2: two steps against one
    process, the loss and grad norm to the bit, the blocks unchanged and
    the head as one process's."""
    outs = _ranks(tmp_path, PROBE_RANK, 2)
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setattr(ptrainer, "build_model", ptrainer.build_model)
        worker.use_tiny_models("supervised", 4)
        cfg = worker.configs(worker.parse_args(TINY_PP + ["--mixup"]))
        cfg.eval_metrics = "linear_prob"
        one = ptrainer.VideoTransformerTrainer(cfg, "cpu")
    init = {k: v.clone() for k, v in one.model.state_dict().items()}
    batch = {k: torch.from_numpy(v)
             for k, v in worker.global_batch(cfg, 4, worker.SEED).items()}
    want = []
    for i in range(2):
        st = one.train_step(batch, 1e-3, worker.WD)
        want.append(f"STEP {i} loss {float(st['loss'])!r} grad_norm "
                    f"{float(st['grad_norm'])!r}")
    for out in outs:
        assert [ln for ln in out.splitlines() if ln.startswith("STEP")] \
            == want
    got = torch.load(tmp_path / "probe.pt", weights_only=True)
    assert all(torch.equal(got["model"][k], v) for k, v in init.items())
    head = one.cls_head.state_dict()
    assert all(torch.equal(got["head"][k], v) for k, v in head.items())


# ------------------------------------------------------------ refusals

@pytest.mark.parametrize("over,match", [
    ({"objective": "mim"}, "supervised only"),
    ({"arch": "mvit"}, "arch timesformer or vivit"),
    ({"arch": "vivit", "attention_type": "fact_encoder"},
     "fact_encoder has two heterogeneous"),
    ({"tp": 2}, "pp composes with data parallelism only"),
    ({"sp": 2}, "pp composes with data parallelism only"),
])
def test_pipeline_trainer_refuses_as_jax(over, match):
    """What JAX's PipelineTrainer refuses (stacked_trainer.py:52-60,
    pp_trainer.py:60-62), the port refuses before it builds anything."""
    cfg = worker.configs(worker.parse_args(TINY_PP))
    for k, v in over.items():
        setattr(cfg, k, v)
    with pytest.raises(AssertionError):
        jpp_trainer.PipelineTrainer(cfg, ckpt_dir=None)
    with pytest.raises(ValueError, match=match):
        pp_trainer.PipelineTrainer(cfg, "cpu")


def test_layers_and_rows_that_do_not_divide_are_refused():
    model = TimeSformer(num_frames=2, img_size=32, embed_dims=32,
                        num_heads=4, num_transformer_layers=4)
    with pytest.raises(ValueError, match="4 layers over 3 stages"):
        pp.Stage(model, pmesh.Mesh(1, 1, 0, None, None, pipe=3))
    # JAX's message (pp_trainer.py:89-93)
    bt, M, data = 6, 4, 1
    with pytest.raises(ValueError) as err:
        pp_trainer.check_rows(bt, M, data)
    assert str(err.value) == (
        f"pipeline microbatching needs batch rows ({bt}) divisible by "
        f"microbatches ({M}) x data axis ({data}); adjust -batch_size or "
        f"-pp_microbatch")
    with pytest.raises(ValueError, match=r"rows \(8\) divisible by "
                       r"microbatches \(2\) x data axis \(8\)"):
        pp_trainer.check_rows(8, 2, 8)
    pp_trainer.check_rows(8, 4, 2)


BASE = ["-epoch", "1", "-batch_size", "2", "-num_class", "400",
        "-objective", "supervised", "-arch", "timesformer",
        "-root_dir", "/tmp", "-num_frames", "8", "-frame_interval", "32",
        "-lr", "0.005", "-train_data_path", "/dev/null"]


@pytest.mark.parametrize("extra,match", [
    (["-pp", "5"], "12 layers over 5 stages"),
    (["-pp", "2", "-tp", "2"], "pp composes with data parallelism only"),
    (["-pp", "2", "-objective", "mim"], "supervised only"),
    (["-pp", "2", "-arch", "mvit"], "arch timesformer or vivit"),
    (["-pp", "2", "-arch", "vivit", "-attention_type", "fact_encoder"],
     "fact_encoder has two heterogeneous"),
])
def test_cli_refuses_pp_before_anything_is_written(tmp_path, extra, match):
    argv = [str(tmp_path) if a == "/tmp" else a for a in BASE] + extra
    with pytest.raises(SystemExit, match=match):
        pcli.single_run(argv + ["-device", "cpu"])
    assert not os.listdir(tmp_path)
    pcli.validate_parallel_flags(pcli.parse_args(BASE + ["-pp", "4"]))
