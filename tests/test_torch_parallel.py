"""The port's tensor- and data-parallel pieces against the JAX package's, on
the CPU, in one process (the multi-process runs are in
tests/test_torch_parallel_mp.py):

- ``qkv_head_block_perm`` and the column and row rules
  (``parallel/tp.py::shard_dim``) against JAX ``parallel/tp.py:57`` and
  ``tp_spec`` (:72), leaf by leaf over TimeSformer and ViViT trees through
  the converter's names;
- ``shard_state_dict`` then ``gather_state_dict``: the state back bit for
  bit, and shards that load into a model built for tp;
- ``validate_parallel_flags`` and the refusals, mirroring
  tests/test_parallel_flags.py (the same messages as the JAX CLI);
- ``Loader``'s index split against JAX ``data/pipeline.py``'s;
- the eval padding (``pad_eval_batch``) against the JAX trainer's
  ``_pad_eval_batch``, and ``shard_batch``'s split;
- mixup on a rank's rows with its partner rank's against mixup on the
  global batch, bit for bit;
- a model hands its mesh to every block at build time;
- the worker's one-process run (tools/mp_train_worker.py, the reference of
  the multi-process tests) against the JAX trainer, three fp32 steps, at
  the tolerances of tests/test_torch_training.py: loss and grad norm rtol
  1e-4, parameters rtol 5e-4 and atol 5e-5, the key third of each qkv bias
  (exact gradient 0: AdamW follows the rounding noise) within 6·lr.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import model_pretrain as jcli
from videotransformer_tpu.data.pipeline import Loader as JLoader
from videotransformer_tpu.models import TimeSformer as JTimeSformer
from videotransformer_tpu.parallel import tp as jtp
from videotransformer_tpu.parallel.mesh import create_mesh as jcreate_mesh
from videotransformer_tpu.parallel.mesh import shard_batch as jshard_batch
from videotransformer_tpu.training import trainer as jtrainer
from videotransformer_tpu_torch import model_pretrain as pcli
from videotransformer_tpu_torch.data.mixup import Mixup
from videotransformer_tpu_torch.data.pipeline import Loader
from videotransformer_tpu_torch.models import convert
from videotransformer_tpu_torch.models.timesformer import TimeSformer
from videotransformer_tpu_torch.models.vivit import ViViT
from videotransformer_tpu_torch.parallel import mesh as pmesh
from videotransformer_tpu_torch.parallel import tp as ptp
from videotransformer_tpu_torch.tools import mp_train_worker as worker
from videotransformer_tpu_torch.training import trainer as ptrainer

TINY = dict(img_size=32, patch_size=16, embed_dims=64, num_heads=4,
            num_transformer_layers=2)


@pytest.mark.parametrize("d,heads,tp", [(768, 12, 2), (768, 12, 3),
                                        (768, 12, 4), (64, 4, 2), (64, 4, 4)])
def test_qkv_head_block_perm_matches_jax(d, heads, tp):
    np.testing.assert_array_equal(ptp.qkv_head_block_perm(d, heads, tp),
                                  jtp.qkv_head_block_perm(d, heads, tp))


def _shape_mesh(tp, data=1, rank=0):
    """A mesh that only sizes a model (no process group behind it)."""
    return pmesh.Mesh(data, tp, rank, None, None)


def _tiny_models(tp=1):
    mesh = None if tp == 1 else _shape_mesh(tp)
    return {
        "timesformer divided": TimeSformer(num_frames=2, **TINY, mesh=mesh),
        "timesformer joint": TimeSformer(
            num_frames=2, **TINY, attention_type="joint_space_time",
            mesh=mesh),
        "vivit fact_encoder": ViViT(num_frames=4, **TINY,
                                    num_time_transformer_layers=2,
                                    mesh=mesh),
        "vivit divided": ViViT(num_frames=4, **TINY,
                               attention_type="divided_space_time",
                               mesh=mesh)}


# JAX's spec of a flax leaf -> the torch dim it splits (kernels are (in,
# out), nn.Linear weights (out, in))
_SPEC_TO_DIM = {("kernel", P(None, "model")): 0, ("bias", P("model")): 0,
                ("kernel", P("model", None)): 1}


@pytest.mark.parametrize("kind", list(_tiny_models()))
def test_shard_rules_match_jax_tp_spec(kind):
    model = _tiny_models()[kind]
    split = 0
    for name, t in model.state_dict().items():
        path, leaf = convert._state_name_to_flax(name)
        flax_leaf = "kernel" if leaf == "weight" and t.dim() == 2 else leaf
        spec = jtp.tp_spec(tuple(path.split("/")) + (flax_leaf,), None)
        want = _SPEC_TO_DIM.get((flax_leaf, spec))
        assert spec == P() or want is not None, (name, spec)
        assert ptp.shard_dim(name) == want, (name, path, spec)
        # trainer and optimizer names carry a prefix
        assert ptp.shard_dim(f"model.{name}") == want
        split += want is not None
    # qkv weight and bias and proj weight an attention, fc1 weight and bias
    # and fc2 weight an FFN
    calls = sum(1 for n in model.state_dict()
                if n.endswith(("qkv.weight", "layers.1.weight")))
    assert split == 3 * calls


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_then_gather_is_bit_exact(tp):
    g = torch.Generator().manual_seed(0)
    for kind, model in _tiny_models().items():
        model.reset_parameters(g)
        full = model.state_dict()
        shards = [ptp.shard_state_dict(full, tp, r, 4) for r in range(tp)]
        back = ptp.gather_state_dict(shards, 4)
        assert list(back) == list(full)
        for k in full:
            assert torch.equal(back[k], full[k]), (kind, k)
        sharded = _tiny_models(tp)[kind]
        for r, shard in enumerate(shards):
            sharded.load_state_dict(shard, strict=True)
        # a rank's qkv rows are its heads' [q|k|v], in that order
        name = next(n for n in full if n.endswith("attn.qkv.weight"))
        d, ghd = full[name].shape[1], 64 // tp
        want = torch.cat([full[name][p * d + (tp - 1) * ghd:
                                     p * d + tp * ghd] for p in range(3)])
        assert torch.equal(shards[-1][name], want)


def test_sharded_block_refuses_its_own_initialisation():
    with pytest.raises(RuntimeError, match="shard_state_dict"):
        TimeSformer(num_frames=2, **TINY,
                    mesh=_shape_mesh(2)).reset_parameters(
            torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="does not divide"):
        TimeSformer(num_frames=2, **TINY, mesh=_shape_mesh(3))


@pytest.mark.parametrize("kind", ["vivit fact_encoder", "timesformer joint"])
def test_model_hands_its_mesh_to_every_block(kind):
    """The blocks know their model group and data rank from the mesh the
    model was built with, and from nothing else: a model built without
    one runs as one process, whatever other model was built with one."""
    mesh = _shape_mesh(2, data=2, rank=3)
    arch, attention = kind.split()
    sharded = {"vivit": ViViT, "timesformer": TimeSformer}[arch](
        num_frames=4, **TINY, mesh=mesh,
        attention_type={"joint": "joint_space_time"}.get(attention,
                                                         attention))
    holders = [m for m in sharded.modules() if hasattr(m, "mesh")]
    assert holders and all(m.mesh is mesh for m in holders)
    shards = [m for m in sharded.modules() if hasattr(m, "tp")]
    assert shards and all(m.tp == 2 for m in shards)
    plain = _tiny_models()[kind]
    plain.reset_parameters(torch.Generator().manual_seed(0))
    plain.train()  # DropPath draws, no collective
    out = plain(torch.zeros(2, 4 if arch == "vivit" else 2, 3, 32, 32),
                torch.Generator().manual_seed(1))
    assert out.shape == (2, 64)


# ---------------------------------------------------- the CLI's flags

BASE = ["-epoch", "1", "-batch_size", "2", "-num_class", "400",
        "-objective", "supervised", "-arch", "timesformer",
        "-root_dir", "/tmp", "-num_frames", "8", "-frame_interval", "32",
        "-lr", "0.005", "-train_data_path", "/dev/null"]


def _both(extra):
    """(JAX CLI's SystemExit message or None, the port's)."""
    out = []
    for cli in (jcli, pcli):
        try:
            cli.validate_parallel_flags(cli.parse_args(BASE + extra))
            out.append(None)
        except SystemExit as exc:
            out.append(str(exc))
    return out


@pytest.mark.parametrize("extra,match", [
    (["-tp", "5"], "does not divide the attention head count"),
    (["-tp", "2", "-arch", "mvit"], "not supported for -arch mvit"),
    (["-sp", "3", "-num_frames", "8"], "must divide both"),
    (["-sp", "2", "-attention_type", "joint_space_time"],
     "divided attention rows"),
])
def test_parallel_flags_refused_as_in_jax(extra, match):
    jmsg, pmsg = _both(extra)
    assert pmsg == jmsg and match in pmsg


@pytest.mark.parametrize("extra", [["-tp", str(t)] for t in (1, 2, 3, 4, 6, 12)]
                         + [["-sp", "2", "-num_frames", "8"]])
def test_parallel_flags_accepted_as_in_jax(extra):
    assert _both(extra) == [None, None]


@pytest.mark.parametrize("flag", ["-pp"])
def test_sequence_and_pipeline_parallelism_still_refused(flag, tmp_path):
    """``-pp`` is ported: in one process it is refused as ``-tp`` and
    ``-sp`` are (the CLI needs torchrun), before anything is written."""
    argv = [str(tmp_path) if a == "/tmp" else a for a in BASE]
    with pytest.raises(SystemExit,
                       match="-pp 2 needs 2 processes or more \\(torchrun"):
        pcli.single_run(argv + [flag, "2", "-device", "cpu"])
    assert not os.listdir(tmp_path)


def test_tp_without_processes_refused(tmp_path):
    with pytest.raises(SystemExit, match="torchrun"):
        pcli.single_run([str(tmp_path) if a == "/tmp" else a for a in BASE]
                        + ["-tp", "2", "-device", "cpu"])


@pytest.mark.parametrize("extra,match", [
    (["-sp", "2"], "-sp 2 needs 2 processes or more \\(torchrun"),
    (["-sp", "2", "-attention_type", "joint_space_time"],
     "divided attention rows"),
    (["-sp", "3"], "must divide both"),
])
def test_sp_runs_under_torchrun_or_is_refused_as_in_jax(tmp_path, extra,
                                                        match):
    """``-sp`` is ported: one process is refused as ``-tp`` is (the CLI
    needs torchrun), and the JAX CLI's refusals stay, with its
    messages."""
    argv = [str(tmp_path) if a == "/tmp" else a for a in BASE] + extra
    with pytest.raises(SystemExit, match=match):
        pcli.single_run(argv + ["-device", "cpu"])
    jmsg, pmsg = _both(extra)
    assert pmsg == jmsg


def test_init_distributed_without_a_card_raises(monkeypatch):
    """The default device is the card: with none visible it raises, and
    nothing lands on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.init_distributed()
    assert pmesh.init_distributed(device="cpu") == torch.device("cpu")


# ---------------------------------------------------- data sharding

class _Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


def _batches(loader):
    return [list(b) for b in loader]


@pytest.mark.parametrize("n,bs,world,shuffle,drop_last", [
    (16, 2, 2, True, True), (17, 3, 2, True, False), (12, 2, 4, False, True),
    (10, 3, 4, True, False), (23, 4, 2, True, True)])
def test_loader_shards_like_jax(n, bs, world, shuffle, drop_last):
    """Each rank reads JAX's indices; with drop_last every rank takes the
    shortest shard's batch count (JAX keeps a longer shard's extra batch:
    n=23, bs=4 gives rank 0 three batches there, rank 1 two)."""
    got, want = [], []
    for rank in range(world):
        kw = dict(batch_size=bs, shuffle=shuffle, drop_last=drop_last,
                  num_workers=2, collate_fn=list, seed=3, process_index=rank,
                  num_processes=world)
        p, j = Loader(_Indices(n), **kw), JLoader(_Indices(n), **kw)
        p.set_epoch(1)
        j.set_epoch(1)
        got.append(_batches(p))
        want.append(_batches(j))
        assert len(p) == len(got[-1])
    if drop_last:
        shortest = min(len(w) for w in want)
        want = [w[:shortest] for w in want]
    assert got == want
    seen = sorted(i for rank in got for b in rank for i in b)
    assert len(seen) == len(set(seen))  # no sample on two ranks


@pytest.mark.parametrize("key,n_crops", [("video", 3), ("video", 1),
                                         ("raw_video", 3)])
def test_eval_padding_matches_the_jax_trainer(key, n_crops):
    """5 samples padded to 6, with label -1 and zero clips, as JAX
    ``_pad_eval_batch`` pads for a mesh of 2 devices: ``n_crops`` rows a
    sample in ``video``, one in ``raw_video`` (crops come on the device)."""
    rng = np.random.RandomState(0)
    rows = 5 * (n_crops if key == "video" else 1)
    batch = {key: (rng.rand(rows, 2, 3, 4, 4) * 255).astype(
                 np.float32 if key == "video" else np.uint8),
             "label": np.array([3, 1, 4, 1, 5], np.int32)}
    jt = SimpleNamespace(mesh=SimpleNamespace(devices=np.zeros(2)))
    want = jtrainer.VideoTransformerTrainer._pad_eval_batch(jt, batch,
                                                            n_crops)
    got = pmesh.pad_eval_batch({k: torch.from_numpy(v)
                                for k, v in batch.items()}, 6, n_crops)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.from_numpy(want[k]).dtype
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_shard_batch_takes_the_data_ranks_rows():
    batch = {"video": np.arange(24.0).reshape(6, 4),
             "label": np.arange(6)}
    for rank in range(3):
        got = pmesh.shard_batch(_shape_mesh(2, data=3, rank=2 * rank + 1),
                                batch)
        np.testing.assert_array_equal(got["label"], [2 * rank, 2 * rank + 1])
        np.testing.assert_array_equal(got["video"],
                                      batch["video"][2 * rank:2 * rank + 2])
    assert pmesh.shard_batch(None, batch) is batch
    with pytest.raises(ValueError, match="do not split"):
        pmesh.shard_batch(_shape_mesh(1, data=4), batch)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("cutmix", [False, True])
def test_mixup_with_the_partner_rank_is_the_global_mixup(world, cutmix):
    """Data rank r's rows mixed with the rows of rank W - 1 - r (what
    ``mesh.partner_rows`` hands it; its own on the middle rank of an odd
    data group) are rank r's rows of mixup on the global batch, bit for
    bit: JAX mixup.py:76 pairs global row i with row B - 1 - i."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2 * world, 2, 3, 8, 8, generator=g)
    labels = torch.randint(0, 10, (2 * world,), generator=g)
    mix = Mixup(num_classes=10)
    draws = {"do_mix": True, "use_cutmix": cutmix, "lam_mixup": 0.3,
             "lam_cutmix": 0.6, "cy": 3, "cx": 5}
    want_x, want_y = mix.apply(x, labels, draws)
    rows = lambda t, r: t[2 * r:2 * r + 2]
    for r in range(world):
        p = world - 1 - r
        got_x, got_y = mix.apply(rows(x, r), rows(labels, r), draws,
                                 partner=(rows(x, p), rows(labels, p)))
        assert torch.equal(got_x, rows(want_x, r))
        assert torch.equal(got_y, rows(want_y, r))


# ---------------------------------------------------- one process vs JAX

def test_worker_one_process_run_matches_jax_trainer(monkeypatch):
    """The multi-process tests' reference: the worker's ``run`` in one
    process, from the JAX trainer's initialisation, three steps on its
    global batch, against the JAX trainer on the same batch."""
    args = worker.parse_args(["--model", "tiny", "--device", "cpu",
                              "--clips", "4", "--steps", "3",
                              "--eval_clips", "0"])
    cfg = worker.configs(args)
    monkeypatch.setattr(jtrainer, "build_model", lambda c: JTimeSformer(
        num_frames=2, **TINY, drop_path_rate=0.0,
        dtype=jtrainer.model_dtype(c)))
    monkeypatch.setattr(ptrainer, "build_model",
                        lambda c, mesh=None: TimeSformer(
                            num_frames=2, **TINY, drop_path_rate=0.0,
                            mesh=mesh))
    jt = jtrainer.VideoTransformerTrainer(
        cfg, ckpt_dir=None, mesh=jcreate_mesh(devices=jax.devices()[:1]))
    params = jax.device_get(jt.params)
    lines = []
    pt = worker.run(args, "cpu", out=lines.append, params=params)
    batch = jshard_batch(jt.mesh, worker.global_batch(cfg, 4, worker.SEED))
    steps = [ln.split()[:6] for ln in lines if ln.startswith("STEP")]
    for step, (_, _, _, loss, _, norm) in enumerate(steps):
        key = jax.random.fold_in(jt.base_key, step)
        jt.params, jt.opt_state, js = jt._train_step(
            jt.params, jt.opt_state, batch, key, jnp.float32(args.lr),
            jnp.float32(worker.WD))
        np.testing.assert_allclose(float(loss), float(js["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(norm), float(js["grad_norm"]),
                                   rtol=1e-4)
    assert len(steps) == 3
    want = convert.flatten_tree(jax.device_get(jt.params))
    got = convert.flatten_tree(pt.params_tree())
    assert sorted(want) == sorted(got)
    lr = args.lr
    for k in want:
        sl = slice(None)
        if k.endswith("attn/qkv/bias"):  # the key third (module doc)
            third = want[k].shape[0] // 3
            np.testing.assert_allclose(got[k][third:2 * third],
                                       want[k][third:2 * third], rtol=0,
                                       atol=6 * lr, err_msg=k)
            sl = np.r_[0:third, 2 * third:3 * third]
        np.testing.assert_allclose(got[k][sl], want[k][sl], rtol=5e-4,
                                   atol=5e-5, err_msg=k)
