"""The frozen operation and byte counts against hand counts, and the model
adapters' counts against the values they gave before they moved out of
``counts.py``."""

import json
import os

import pytest

from vtbench import counts, registry

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TSF, MVIT = "timesformer_b16_divst_8x224", "mvit_b_maskfeat_16x224"


def _config(name):
    with open(os.path.join(REPO, "vtbench", "configs", name + ".json")) as f:
        return json.load(f)


def _adapter(cfg):
    return registry.model(REPO, cfg["model"])


def test_b1_b3_hand_count():
    # 2 sequences of 4 tokens, width 8, 2 heads of 4
    f, b = counts.b1(2, 4, 8, heads=2)
    qkv, att, proj = 2 * 8 * 8 * 24, 4 * 2 * 2 * 16 * 4, 2 * 8 * 8 * 8
    assert f == qkv + att + proj
    assert b == 2 * (2 * 8 * 8 + 4 * 8 * 8 + 4 * 8 + 2 * 8)
    f3, _ = counts.b3(2, 4, 8, heads=2)
    assert f3 == 2 * proj + 2 * att + 2 * qkv


def test_b2_b4_b5_b6_hand_count():
    assert counts.b2(10, 8, 32)[0] == 2 * 10 * 8 * 32 * 2
    assert counts.b4(10, 8, 32)[0] == 4 * 2 * 10 * 8 * 32
    assert counts.b5(2, 3, 5, 7, 4)[0] == 2 * 3 * (2 * 5 * 7 * 4) * 2
    assert counts.b6(2, 3, 5, 7, 4)[0] == 2 * counts.b5(2, 3, 5, 7, 4)[0]
    assert counts.b5(2, 3, 5, 7, 4)[1] == 2 * 2 * 3 * 4 * (2 * 5 + 2 * 7)


def test_mvit_pool_hand_count():
    # one clip, a 2x4x4 grid, width 8; q unpooled, k and v pooled 3³ at
    # stride (1, 2, 2): every input position read, a 2x2x2 output
    geometry = (None, ((3, 3, 3), (1, 2, 2)), ((3, 3, 3), (1, 2, 2)))
    f, b = counts.mvit_pool(1, (2, 4, 4), 8, geometry)
    assert f == 2 * (2 * 27 * 8 * 8)
    assert b == 2 * (2 * 8 * (32 + 8))
    f, b = counts.mvit_pool(1, (2, 4, 4), 8, geometry, backward=True)
    assert f == 2 * (4 * 27 * 8 * 8)
    assert b == 2 * 32 * 24 + 2 * 32 * 8 + 2 * (2 * 8 * (32 + 8))
    # stride 4 over 7 positions: windows centred on 0 and 4 read 0, 1 and
    # 3, 4, 5, and never 2 or 6
    _, b = counts.mvit_pool(1, (1, 1, 7), 1, (((1, 1, 3), (1, 1, 4)),))
    assert b == 2 * (5 + 2)


def test_bound_is_the_larger_of_the_two():
    assert counts.bound_s(989e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_timesformer_forward_flops_by_hand():
    cfg = dict(model="timesformer", attention_type="divided_space_time",
               num_frames=2, img_size=32, patch_size=16, embed_dims=8,
               num_heads=2, num_transformer_layers=1, mlp_ratio=4,
               in_channels=3, num_class=5)
    T, P, D, hd, B = 2, 4, 8, 4, 1
    patch = 2 * T * P * 768 * D
    temporal = 2 * P * T * D * 3 * D + 4 * P * 2 * T * T * hd \
        + 2 * 2 * P * T * D * D
    spatial = 2 * T * (P + 1) * D * 3 * D + 4 * T * 2 * (P + 1) ** 2 * hd \
        + 2 * T * (P + 1) * D * D
    ffn = 2 * (P * T + 1) * D * 32 * 2
    assert _adapter(cfg).fwd_flops(cfg, B) == \
        patch + temporal + spatial + ffn + 2 * D * 5


def test_timesformer_b16_matches_the_published_order():
    # ~190 GFLOPs a view of TimeSformer-B 8x224 (Bertasius et al.: 0.59
    # TFLOPs over 3 views)
    cfg = _config(TSF)
    model = _adapter(cfg)
    assert 180e9 < model.fwd_flops(cfg, 1) / 1 < 400e9
    calls = model.kernel_calls(cfg, 8 * 3, backward=False)
    assert len(calls) == 36  # B1 twice and B2 once a layer
    assert len(model.kernel_calls(cfg, 16, backward=True)) == 72


def test_mvit_schedule_and_flops():
    cfg = _config(MVIT)
    blocks = _adapter(cfg).reference.blocks(cfg)
    assert [b["dim"] for b in blocks] == [96] + [192] * 2 + [384] * 11 + \
        [768] * 2
    assert [b["heads"] for b in blocks] == [1] + [2] * 2 + [4] * 11 + [8] * 2
    assert [i for i, b in enumerate(blocks) if b["pool_q"]] == [1, 3]
    assert blocks[-1]["thw"] == (8, 14, 14)
    assert blocks[0]["stride_kv"] == [1, 8, 8]
    assert blocks[3]["stride_kv"] == [1, 2, 2]
    # MViT-B 16x4: 70.5 GFLOPs (multiply-adds) a view in Fan et al.
    flops = _adapter(cfg).fwd_flops(cfg, 1)
    assert 120e9 < flops < 180e9
    calls = _adapter(cfg).kernel_calls(cfg, 16, backward=True)
    # B5 and B6 in all 16 blocks, B2 and B4 where the width stays, the
    # pools forward and backward in every block
    assert len(calls) == 16 * 2 + 13 * 2 + 16 * 2


# The values of the counts before they moved into the adapters (the parent
# code's ``counts.fwd_flops`` and ``counts.kernel_calls``), at the cells'
# sizes: a served request's 3 crops, a bucket of 8 requests, a train step's
# 32 clips and a traced window's 6 steps.
BEFORE_FLOPS = [(TSF, 1, 391660560384), (TSF, 3, 1174981681152),
                (TSF, 192, 75198827593728), (MVIT, 1, 172807606656),
                (MVIT, 192, 33179060477952)]
BEFORE_BOUND = [(TSF, 24, False, 36, 0.008920865548683519),
                (TSF, 32, True, 72, 0.035683462194734075),
                (MVIT, 32, True, 58, 0.009760658033375127)]


@pytest.mark.parametrize("name,clips,flops", BEFORE_FLOPS)
def test_forward_flops_unchanged(name, clips, flops):
    cfg = _config(name)
    assert _adapter(cfg).fwd_flops(cfg, clips) == flops


@pytest.mark.parametrize("name,clips,backward,n,bound", BEFORE_BOUND)
def test_kernel_bound_unchanged_but_the_pools(name, clips, backward, n,
                                              bound):
    """The calls counted before come first and bound the same to the bit;
    MaskFeat's pools follow them, and only they add to the bound."""
    cfg = _config(name)
    model = _adapter(cfg)
    calls = model.kernel_calls(cfg, clips, backward)
    assert counts.total_bound_s(calls[:n]) == bound
    pools = calls[n:]
    if name == MVIT:
        want = [counts.mvit_pool(clips, *p, backward=bw)
                for p in model.pools(cfg) for bw in (False, True)]
        assert pools == want
    else:
        assert pools == []
    assert counts.total_bound_s(calls) == \
        bound + sum(counts.bound_s(f, b) for f, b in pools)


def test_pools_of_a_maskfeat_step():
    """The 16 pool calls (34 pools) of a MaskFeat step at the cell's 32
    clips move 2.81 GB forward and 7.28 GB backward, bound by the bytes:
    about 3.01 ms."""
    cfg = _config(MVIT)
    pools = _adapter(cfg).pools(cfg)
    assert len(pools) == 16
    assert sum(g is not None for _, _, geo in pools for g in geo) == 34
    fwd = [counts.mvit_pool(32, *p) for p in pools]
    bwd = [counts.mvit_pool(32, *p, backward=True) for p in pools]
    assert sum(b for _, b in fwd) == pytest.approx(2.81e9, rel=0.01)
    assert sum(b for _, b in bwd) == pytest.approx(7.28e9, rel=0.01)
    assert counts.total_bound_s(fwd + bwd) == pytest.approx(3.01e-3,
                                                            rel=0.01)
    assert all(b / counts.PEAK_HBM_BYTES > f / counts.PEAK_BF16_FLOPS
               for f, b in fwd + bwd)


@pytest.mark.parametrize("name,key,value", [
    (TSF, "attention_type", "joint_space_time"),
    (TSF, "attention_type", "space_only"),
    (MVIT, "trainer.objective", "supervised"),
])
@pytest.mark.parametrize("count", ["fwd_flops", "kernel_calls"])
def test_an_adapter_refuses_what_it_does_not_count(name, key, value, count):
    cfg = _config(name)
    if "." in key:
        outer, inner = key.split(".")
        cfg[outer] = dict(cfg[outer], **{inner: value})
    else:
        cfg[key] = value
    fn = getattr(_adapter(cfg), count)
    with pytest.raises(ValueError, match=value):
        fn(cfg, 32) if count == "fwd_flops" else fn(cfg, 32, True)
