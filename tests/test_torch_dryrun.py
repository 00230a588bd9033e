"""The port's twin of ``__graft_entry__.py``
(``videotransformer_tpu_torch/graft_entry.py``) on the CPU:

- ``dryrun_multichip(4, device="cpu")``: four gloo ranks (the ``JAX_``/
  ``XLA_`` environment stripped), one supervised step with mixup on dp2 x
  tp2 and one on dp2 x pp2, each within JAX's bounds of the same global
  batch in one process (loss 1e-4, grad norm 1e-3 of max(1, |one
  process's|)), rank 0 printing JAX's line ending in ``OK``; and at two
  ranks (dp2 alone, no pipeline leg, as JAX runs it below four devices);
- ``entry``: the flagship forward's surface, TimeSformer-B/16 on a zero
  (1, 8, 3, 224, 224) clip to (1, 400) finite logits, and both entry
  points refusing a card where there is none.
"""

import os
import re

import pytest
import torch

from videotransformer_tpu_torch import graft_entry


@pytest.fixture
def port_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith(("JAX_", "XLA_")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


LINE = (r"dryrun_multichip\((\d+)\) mesh=dp(\d+)xsp(\d+)xtp(\d+): "
        r"loss=(\S+) grad_norm=(\S+) \(1-device check: loss=(\S+) "
        r"grad_norm=(\S+)\)(.*) OK")


@pytest.mark.parametrize("n,mesh,pp", [(4, ("2", "1", "2"), True),
                                       (2, ("2", "1", "1"), False)])
def test_dryrun_multichip_on_cpu(port_env, capfd, n, mesh, pp):
    graft_entry.dryrun_multichip(n, device="cpu", timeout_s=240)
    out = capfd.readouterr().out
    (match,) = re.findall(LINE, out)
    assert match[0] == str(n) and match[1:4] == mesh
    loss, norm, loss1, norm1 = map(float, match[4:8])
    assert abs(loss - loss1) < 1e-4 * max(1.0, abs(loss1))
    assert abs(norm - norm1) < 1e-3 * max(1.0, abs(norm1))
    if pp:
        (pp_loss, pp_norm), = re.findall(
            rf" dp{n // 2}xpp2 train loss=(\S+) grad_norm=(\S+)", match[8])
        assert abs(float(pp_loss) - loss1) < 1e-4 * max(1.0, abs(loss1))
        assert abs(float(pp_norm) - norm1) < 1e-3 * max(1.0, abs(norm1))
    else:
        assert match[8] == ""


def test_entry_is_the_flagship_forward():
    fn, args = graft_entry.entry(device="cpu")
    model, head, video = args
    assert tuple(video.shape) == (1, 8, 3, 224, 224)
    assert model.attention_type == "divided_space_time"
    assert len(model.transformer_layers.layers) == 12
    out = fn(*args)
    assert tuple(out.shape) == (1, 400) and out.dtype == torch.float32
    assert torch.isfinite(out).all()


def test_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="needs a card"):
        graft_entry.dryrun_multichip(4)
