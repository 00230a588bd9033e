"""The port's ring attention (``parallel/sp.py::ring_prenorm_mhsa``) against
JAX's, and joint attention trained over sequence parallelism, on the CPU:

- JAX's own ``ring_prenorm_mhsa`` runs here on its 8-device CPU mesh, data
  2 x seq 2 (seq 4 for the uneven tail), at n = 8, 9 and 13 tokens (sp 2)
  and n = 9 (sp 4: two full shards, one partial, one of padding alone),
  width 32, 4 heads, fp32, and writes its inputs, output and the
  gradients of (out · g).sum() with respect to x and every weight as
  ``.npz``. Four gloo worker processes, with the ``JAX_``/``XLA_``
  environment stripped, run the port's ring on JAX's layout (each rank
  its data rows and its chunk of ceil(n / sp) tokens, ``sp.token_chunk``)
  and write theirs; the weight gradients are summed over the ranks.
  Bounds are tests/test_ring_attention.py's: forward rtol 2e-5 / atol
  2e-6, gradients rtol 5e-4 / atol 1e-5. The same ranks then run the ring
  and the all-to-all through the NCCL form of the seq moves
  (``all_to_all_single``, ``batch_isend_irecv``), which gloo also takes on
  CPU tensors, bit-equal to the broadcast form.
- A tiny joint TimeSformer over SP = 2 (the ring in the trainer: the cls
  row's key and value shared, every patch token's on one rank), three
  steps with mixup and DropPath 0.1 and a fit epoch, against the worker's
  run in one process at tests/test_torch_parallel_mp.py's bounds,
  parameters after the first step included: a cls key counted twice would
  show in the loss. The steps take SGD, as that file's MaskFeat step does
  and for its reason: the ring sums the softmax in another order than the
  one process's full rows, and AdamW turns that rounding noise into steps
  of about lr on elements whose gradient is below AdamW's eps (after one
  AdamW step an fc1 element whose gradient is 8.7e-9 in one process and
  9.2e-9 over the ring parts by 1.4e-5); SGD's update is linear in the
  gradient, so the parameters show the gradients themselves at rtol 1e-4.
"""

import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from videotransformer_tpu.parallel import sp as jsp
from videotransformer_tpu.parallel.mesh import create_mesh as jcreate_mesh

import test_torch_parallel_mp as mp

CASES = {"n8-sp2": (8, 2, 4), "n9-sp2": (9, 2, 4), "n13-sp2": (13, 2, 4),
         "n9-sp4": (9, 4, 2)}  # n, sp, batch
D, HEADS = 32, 4
WEIGHTS = ("ln_w", "ln_b", "w_qkv", "b_qkv", "w_proj", "b_proj")


def _inputs(n, batch, seed=0):
    """x, the cotangent g and the weights (JAX's (in, out) kernels)."""
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=1.0, mean=0.0: (
        rng.randn(*s) * scale + mean).astype(np.float32)
    return {"x": f(batch, n, D, scale=0.5), "g": f(batch, n, D),
            "ln_w": f(D, scale=0.1, mean=1.0), "ln_b": f(D, scale=0.1),
            "w_qkv": f(D, 3 * D, scale=0.1), "b_qkv": f(3 * D, scale=0.1),
            "w_proj": f(D, D, scale=0.1), "b_proj": f(D, scale=0.1)}


def _jax_ring(case):
    n, sp, batch = CASES[case]
    inp = _inputs(n, batch)
    mesh = jcreate_mesh(data=2, seq=sp, devices=jax.devices()[:2 * sp])
    args = [jnp.asarray(inp[k]) for k in ("x",) + WEIGHTS]

    def ring(*a):
        return jsp.ring_prenorm_mhsa(*a, HEADS, (D // HEADS) ** -0.5, 1e-5)

    with jsp.sequence_parallel(mesh):
        out = jax.jit(ring)(*args)
        grads = jax.jit(jax.grad(
            lambda *a: (ring(*a) * inp["g"]).sum(),
            argnums=tuple(range(7))))(*args)
    return inp, np.asarray(out), [np.asarray(g) for g in grads]


# one rank: every case on JAX's layout, then the NCCL form of the moves
RING_RANK = """
import sys, numpy as np, torch
from videotransformer_tpu_torch.parallel import mesh, sp
rank, store, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
mesh.init_distributed("gloo", store, rank, 4, "cpu")
meshes = {2: mesh.create_mesh(seq=2), 4: mesh.create_mesh(seq=4)}
def run(case, n, s, heads=4):
    m = meshes[s]
    inp = np.load(f"{d}/{case}.in.npz")
    t = {k: torch.from_numpy(inp[k]) for k in inp.files}
    rows = t["x"].shape[0] // m.data
    cut = lambda a: sp.token_chunk(a[m.data_rank * rows:
                                     (m.data_rank + 1) * rows], m)
    x = cut(t["x"]).clone().requires_grad_()
    w = {"ln_w": t["ln_w"], "ln_b": t["ln_b"], "w_qkv": t["w_qkv"].T,
         "b_qkv": t["b_qkv"], "w_proj": t["w_proj"].T, "b_proj": t["b_proj"]}
    w = {k: v.contiguous().requires_grad_() for k, v in w.items()}
    out = sp.ring_prenorm_mhsa(x, *w.values(), 32 // heads,
                               (32 // heads) ** -0.5, 1e-5, m, n=n)
    (out * cut(t["g"])).sum().backward()
    grads = [w[k].grad for k in w]
    for gr in grads:
        torch.distributed.all_reduce(gr)
    return out.detach(), x.grad, grads
for case, n, s in [("n8-sp2", 8, 2), ("n9-sp2", 9, 2), ("n13-sp2", 13, 2),
                   ("n9-sp4", 9, 4)]:
    out, dx, grads = run(case, n, s)
    np.savez(f"{d}/{case}.rank{rank}.npz", out=out.numpy(), dx=dx.numpy(),
             **{f"d{i}": g.numpy() for i, g in enumerate(grads)})
ref = run("n13-sp2", 13, 2)
x = torch.randn(2, 4, 6, 3, generator=torch.Generator().manual_seed(rank))
ref_a = mesh.all_to_all(x, meshes[2], 2, 1)
mesh.p2p_form = lambda group: True
got = run("n13-sp2", 13, 2)
same = torch.equal(ref[0], got[0]) and torch.equal(ref[1], got[1]) and all(
    torch.equal(a, b) for a, b in zip(ref[2], got[2]))
same = same and torch.equal(ref_a, mesh.all_to_all(x, meshes[2], 2, 1))
print("P2P_SAME", same, flush=True)
torch.distributed.destroy_process_group()
print("WORKER OK", flush=True)
"""


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    """(JAX's results by case, the four ranks' outputs, their directory)."""
    d = tmp_path_factory.mktemp("ring")
    ref = {}
    for case in CASES:
        inp, out, grads = _jax_ring(case)
        np.savez(d / f"{case}.in.npz", **inp)
        ref[case] = (inp, out, grads)
    store = f"file://{d}/store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", RING_RANK, str(r), store, str(d)],
        cwd=mp.REPO, env=mp._env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
        for r in range(4)]
    outs = mp._communicate(procs)
    return ref, outs, d


@pytest.mark.parametrize("case", list(CASES))
def test_ring_matches_jax_ring(ring_runs, case):
    ref, outs, d = ring_runs
    for out in outs:
        assert "WORKER OK" in out, out[-3000:]
    n, sp, batch = CASES[case]
    inp, want_out, want_grads = ref[case]
    n_l = -(-n // sp)
    data = 4 // sp
    rows = batch // data
    got_out = np.zeros_like(want_out)
    got_dx = np.zeros_like(want_grads[0])
    for rank in range(4):
        res = np.load(d / f"{case}.rank{rank}.npz")
        dr, sr = divmod(rank, sp)
        lo, hi = sr * n_l, min((sr + 1) * n_l, n)
        if lo >= n:  # a shard of padding alone
            continue
        got_out[dr * rows:(dr + 1) * rows, lo:hi] = res["out"][:, :hi - lo]
        got_dx[dr * rows:(dr + 1) * rows, lo:hi] = res["dx"][:, :hi - lo]
    np.testing.assert_allclose(got_out, want_out, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got_dx, want_grads[0], rtol=5e-4, atol=1e-5)
    res = np.load(d / f"{case}.rank0.npz")
    for i, name in enumerate(WEIGHTS):
        got = res[f"d{i}"]
        if name.startswith("w_"):
            got = got.T  # torch's (out, in)
        np.testing.assert_allclose(got, want_grads[1 + i], rtol=5e-4,
                                   atol=1e-5, err_msg=name)


def test_nccl_form_of_the_moves_is_bit_equal(ring_runs):
    _, outs, _ = ring_runs
    for out in outs:
        assert "P2P_SAME True" in out, out[-3000:]


def test_joint_sp2_matches_one_process(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    argv = mp.SUPERVISED + ["--attention_type", "joint_space_time",
                            "--optim", "sgd"]
    outs = mp._spawn(tmp_path, 2, argv + ["--sp", "2", "--ckpt", ckpt])
    mp._check(outs, argv, ckpt, adamw=False)
