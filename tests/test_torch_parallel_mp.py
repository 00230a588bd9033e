"""Data and tensor parallelism of the port in real processes over gloo on
the CPU: ``videotransformer_tpu_torch/tools/mp_train_worker.py`` on a tiny
TimeSformer (2 layers, width 64, 4 heads, 2 frames at 32², fp32), each run
held against the same worker ``run`` in this process on the global batch
(itself held against the JAX trainer in tests/test_torch_parallel.py):

- DP = 2, TP = 2 and TP = 2 with every block checkpointed (``--remat``,
  against the one process without it), three AdamW steps with mixup and
  DropPath 0.1 on a
  global batch of 4 clips, then one epoch of the trainer's ``fit``: one
  more step, and a validation and a three-crop test of 5 clips, which
  each data rank reads through its ``Loader`` shard in batches of 2 (under
  DP rank 0 three clips in two batches, rank 1 two in one: the trainer's
  eval pads rank 1's short round and gives it a round of padding alone);
- the same on a tiny ViViT fact_encoder (4 frames, tube 2) over DP = 2 x
  TP = 2, four ranks under torchrun: its temporal stack's cls rows are the
  ``x[:b, 0]`` rows of the global batch, sample 0's frames, which the
  second data rank reads from the first, in every train and eval forward
  (a collective that uneven eval shards would leave unmatched);
- joint attention's unfused branch (the flash attention kernel's plain
  version; the branch lowered to 16 tokens) and its fused one, forward and
  every gradient, over TP = 2 against the full module;
- a DP = 2 MaskFeat step (a depth-4 MaskFeat) whose two ranks hold clips of
  very different mask counts, so that only the global count gives the
  one-process loss.

Every rank prints the same lines (loss, grad norm, top-k, the digest of
the gathered parameters), and rank 0's gathered checkpoints, written after
each step, load into a one-process trainer. Tolerances, no looser than the
JAX package's tests/test_tensor_parallel.py:86-89, which holds one step:
loss 1e-5 and grad norm 1e-3 absolute at every step, top-k counts equal,
and the parameters after the first step rtol 1e-4 and atol 1e-6. AdamW
moves an element by about lr whatever the size of its gradient, so an
element whose gradient is near the rounding noise of the gradient sums
follows the noise, and the noise grows with the steps: after the third
step the parameters are held as tests/test_torch_training.py holds them
(rtol 5e-4, atol 5e-5, 5% of one step at lr 1e-3; measured worst 3.7e-5).
The ViViT run is held so after its first step too: there one process
against itself, with 1 and with 8 threads, already parts by 2.2e-5 beyond
rtol 1e-4 after one step (an fc2 element of its temporal stack), so JAX's
atol 1e-6 cannot hold even without a second rank.
The key third of each qkv bias has an exact gradient of 0 (a shift of
every key leaves the softmax as it is), so it is all noise: held to 6·lr
after every step, as there. The MaskFeat step takes SGD for the same
reason: at its clip of 1.0 AdamW turns the noise of many small gradients
into steps of up to 0.25·lr after one step (measured), and SGD's update is
linear in the gradient, so its parameters show the gradient itself at
rtol 1e-4.

Each subprocess has its own timeout and is killed when it expires; the
ranks meet through a FileStore in the test's tmp_path, torchrun through
its standalone rendezvous on a free port.
"""

import os
import re
import signal
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from videotransformer_tpu_torch.models.convert import flatten_tree
from videotransformer_tpu_torch.parallel import mesh as pmesh
from videotransformer_tpu_torch.tools import mp_train_worker as worker
from videotransformer_tpu_torch.training import trainer as ptrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "videotransformer_tpu_torch.tools.mp_train_worker"
TIMEOUT_S = 90
TINY_CPU = ["--model", "tiny", "--device", "cpu"]
SUPERVISED = TINY_CPU + ["--mixup", "--drop_path", "0.1", "--eval_clips",
                         "5"]


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["OMP_NUM_THREADS"] = "2"
    env["PYTHONPATH"] = REPO
    return env


def _communicate(procs):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)  # torchrun's ranks too
                p.communicate()
    return outs


def _spawn(tmp_path, world, args):
    """``world`` worker processes meeting in a FileStore; their stdouts."""
    store = f"file://{tmp_path}/store"
    procs = [subprocess.Popen(
        [sys.executable, "-m", MODULE, "--rank", str(r), "--world",
         str(world), "--init", store, *args],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        start_new_session=True) for r in range(world)]
    return _communicate(procs)


def _torchrun(tmp_path, world, args):
    """``world`` ranks under torchrun (its env:// rendezvous); each rank's
    stdout from torchrun's per-rank logs."""
    logs = tmp_path / "logs"
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(world), "--redirects", "3", "--log-dir",
         str(logs), "-m", MODULE, *args],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    _communicate([proc])
    (run,) = list(logs.iterdir())
    return [(run / "attempt_0" / str(r) / "stdout.log").read_text()
            for r in range(world)]


def _parse(out):
    assert "WORKER OK" in out, out[-3000:]
    # a step's line without its times
    lines = [re.sub(r" ms .*", "", ln) for ln in out.splitlines()
             if ln.startswith(("STEP", "VAL", "TEST", "DIGEST"))]
    steps = [tuple(float(v) for v in re.findall(r"loss (\S+) grad_norm (\S+)",
                                                ln)[0])
             for ln in lines if ln.startswith("STEP")]
    evals = {ln.split()[0]: (float(ln.split()[2]), float(ln.split()[4]))
             for ln in lines if ln.startswith(("VAL", "TEST"))}
    return lines, steps, evals


def _one_process(argv):
    """The worker's ``run`` here, in one process, on the global batch; its
    parameters after each step."""
    args = worker.parse_args(argv)
    lines, params = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ptrainer, "build_model", ptrainer.build_model)
        worker.use_tiny_models(args.objective)
        tr = worker.run(args, "cpu", out=lines.append, on_step=lambda i, t:
                        params.append({k: np.array(v) for k, v in
                                       flatten_tree(t.params_tree()).items()}))
    return _parse("\n".join(lines + ["WORKER OK"])), tr, params, args


def _params_close(got, want, lr, rtol, atol, key_bias=True):
    assert sorted(want) == sorted(got)
    for k in want:
        sl = slice(None)
        if key_bias and k.endswith("attn/qkv/bias"):
            third = want[k].shape[0] // 3  # the key third (module doc)
            np.testing.assert_allclose(got[k][third:2 * third],
                                       want[k][third:2 * third], rtol=0,
                                       atol=6 * lr, err_msg=k)
            sl = np.r_[0:third, 2 * third:3 * third]
        np.testing.assert_allclose(got[k][sl], want[k][sl], rtol=rtol,
                                   atol=atol, err_msg=k)


def _global_evals(ref, args, data):
    """The one-process trainer ``ref``'s top-k on the global eval batches
    that ``data`` data ranks hold together: each round, rank 0's ``Loader``
    batch, then rank 1's, each padded as the trainer pads it (module
    doc)."""
    cfg = worker.configs(args)
    ranks = [worker.data_module(None, args, cfg, SimpleNamespace(
        data_rank=r, data=data)) for r in range(data)]
    out = {}
    for what, loader, n_crops in (("VAL", "val_loader", 1),
                                  ("TEST", "test_loader", 3)):
        shards = [list(getattr(m, loader)()) for m in ranks]
        rounds = []
        for k in range(max(map(len, shards))):
            parts = [{n: torch.from_numpy(v) for n, v in s[k].items()}
                     for s in shards if k < len(s)]
            size = max(p["label"].shape[0] for p in parts)
            parts = [pmesh.pad_eval_batch(p, size, n_crops) for p in parts]
            rounds.append({n: torch.cat([p[n] for p in parts])
                           for n in parts[0]})
        top = (ref.validate if what == "VAL" else ref.test)(rounds)
        out[what] = tuple(float(f"{v:.10e}") for v in top)
    return out


def _check(outs, argv, ckpt, adamw=True, first=(1e-4, 1e-6), data=1):
    (_, ref_steps, ref_evals), ref, ref_params, args = _one_process(argv)
    parsed = [_parse(o) for o in outs]
    for lines, _, _ in parsed[1:]:  # every rank printed the same
        assert lines == parsed[0][0]
    _, steps, evals = parsed[0]
    assert len(steps) == len(ref_steps) == args.steps
    for (loss, norm), (want_loss, want_norm) in zip(steps, ref_steps):
        assert abs(loss - want_loss) <= 1e-5, (loss, want_loss)
        assert abs(norm - want_norm) <= 1e-3, (norm, want_norm)
    want = ref_evals if data == 1 else _global_evals(ref, args, data)
    assert evals == want
    # rank 0's gathered checkpoints, in a one-process trainer
    last = args.steps - 1
    for step, (rtol, atol) in ((0, first), (last, (5e-4, 5e-5))):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ptrainer, "build_model", ptrainer.build_model)
            worker.use_tiny_models(args.objective)
            tr = ptrainer.VideoTransformerTrainer(worker.configs(args),
                                                  "cpu")
            tr.load_checkpoint(f"{ckpt}.{step}")
        assert tr.global_step == step + 1
        _params_close(flatten_tree(tr.params_tree()), ref_params[step],
                      args.lr, rtol, atol, key_bias=adamw)
    # the optimizer's moments came back whole too
    for k, m in ref.optimizer.mu.items():
        assert tr.optimizer.mu[k].shape == m.shape, k


@pytest.mark.parametrize("what,world,extra,data", [
    ("dp2", 2, [], 2), ("tp2", 2, ["--tp", "2"], 1),
    # every block checkpointed: the backward's second forward runs the
    # model group's all-reduces again; the one process runs without remat
    ("tp2-remat", 2, ["--tp", "2", "--remat"], 1)])
def test_two_processes_match_one_process(tmp_path, what, world, extra, data):
    ckpt = str(tmp_path / "ckpt")
    argv = SUPERVISED + extra
    outs = _spawn(tmp_path, world, argv + ["--ckpt", ckpt])
    _check(outs, SUPERVISED, ckpt, data=data)


def test_vivit_dp2_tp2_under_torchrun_matches_one_process(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    argv = SUPERVISED + ["--arch", "vivit", "--attention_type",
                         "fact_encoder"]
    outs = _torchrun(tmp_path, 4, argv + ["--tp", "2", "--ckpt", ckpt])
    _check(outs, argv, ckpt, first=(5e-4, 5e-5), data=2)  # module doc


# one rank of the joint attention check: the full module and this rank's
# shard from the same seed, a forward and backward of each branch
JOINT_RANK = """
import sys, torch
from videotransformer_tpu_torch.ops import blocks
from videotransformer_tpu_torch.parallel import mesh, tp
rank, store = int(sys.argv[1]), sys.argv[2]
mesh.init_distributed("gloo", store, rank, 2, "cpu")
m = mesh.create_mesh(model=2)
def block(mesh_):  # under a block's names, which the shard rules read
    return torch.nn.ModuleDict({"attentions": torch.nn.ModuleList(
        [blocks.JointAttention(64, 4, mesh=mesh_)])})
full, part = block(None), block(m)
full.attentions[0].reset_parameters(torch.Generator().manual_seed(0))
part.load_state_dict(tp.shard_state_dict(full.state_dict(), 2, rank, 4))
x = torch.randn(2, 33, 64, generator=torch.Generator().manual_seed(1))
g = torch.randn(2, 33, 64, generator=torch.Generator().manual_seed(2))
for max_n in (2048, 16):  # fused (B1/B3), then unfused (flash attention)
    blocks.FUSED_MHSA_MAX_N = max_n
    outs = []
    for mod, over in ((full, None), (part, m)):
        xi = x.clone().requires_grad_()
        mod.zero_grad()
        out = mod.attentions[0](xi)
        (out * g).sum().backward()
        grads = {n: p.grad for n, p in mod.named_parameters()}
        grads = tp.gather_over_model(grads, over, 4)
        outs.append((out.detach(), xi.grad, grads))
    (o1, dx1, g1), (o2, dx2, g2) = outs
    err = max([float((o1 - o2).abs().max()), float((dx1 - dx2).abs().max())]
              + [float((g1[n] - g2[n]).abs().max()) for n in g1])
    print("MAXERR", max_n, err, flush=True)
print("WORKER OK", flush=True)
"""


def test_joint_attention_branches_over_tp2(tmp_path):
    store = f"file://{tmp_path}/store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", JOINT_RANK, str(r), store], cwd=REPO,
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True) for r in range(2)]
    for out in _communicate(procs):
        assert "WORKER OK" in out, out[-3000:]
        errs = dict(re.findall(r"MAXERR (\d+) (\S+)", out))
        assert set(errs) == {"2048", "16"}, out
        assert all(float(e) <= 1e-5 for e in errs.values()), errs


def test_dp2_mim_step_takes_the_global_mask_count(tmp_path):
    argv = TINY_CPU + ["--objective", "mim", "--steps", "1", "--optim",
                       "sgd"]
    cfg = worker.configs(worker.parse_args(argv))
    mask = worker.global_batch(cfg, 4, 0)["mask"]
    per_rank = mask.reshape(2, -1).sum(1)
    assert per_rank[0] > 2 * per_rank[1]  # the ranks' counts differ
    ckpt = str(tmp_path / "ckpt")
    outs = _spawn(tmp_path, 2, argv + ["--ckpt", ckpt])
    _check(outs, argv, ckpt, adamw=False)
    # the mean of the two ranks' own masked means is another loss, far
    # outside the 1e-5 the step is held to
    batch = {k: torch.from_numpy(v)
             for k, v in worker.global_batch(cfg, 4, 0).items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ptrainer, "build_model", ptrainer.build_model)
        worker.use_tiny_models("mim")
        model = ptrainer.VideoTransformerTrainer(cfg, "cpu").model.eval()

    @torch.no_grad()
    def loss(rows):
        b = {k: v[rows] for k, v in batch.items()}
        return float(model(b["video"], b["hog"], b["mask"],
                           b["cube_marker"], b["cube_count"])[1])

    per_rank_mean = (loss(slice(0, 2)) + loss(slice(2, 4))) / 2
    assert abs(per_rank_mean - loss(slice(0, 4))) > 1e-2
