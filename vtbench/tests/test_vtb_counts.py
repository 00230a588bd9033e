"""The frozen operation and byte counts against hand counts."""

import json
import os

import pytest

from vtbench import counts

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _config(name):
    with open(os.path.join(REPO, "vtbench", "configs", name + ".json")) as f:
        return json.load(f)


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


def test_bound_is_the_larger_of_the_two():
    assert counts.bound_s(989e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_timesformer_forward_flops_by_hand():
    cfg = dict(num_frames=2, img_size=32, patch_size=16, embed_dims=8,
               num_heads=2, num_transformer_layers=1, mlp_ratio=4,
               in_channels=3, num_class=5)
    T, P, D, hd, B = 2, 4, 8, 4, 1
    patch = 2 * T * P * 768 * D
    temporal = 2 * P * T * D * 3 * D + 4 * P * 2 * T * T * hd \
        + 2 * 2 * P * T * D * D
    spatial = 2 * T * (P + 1) * D * 3 * D + 4 * T * 2 * (P + 1) ** 2 * hd \
        + 2 * T * (P + 1) * D * D
    ffn = 2 * (P * T + 1) * D * 32 * 2
    assert counts.timesformer_fwd_flops(cfg, B) == \
        patch + temporal + spatial + ffn + 2 * D * 5


def test_timesformer_b16_matches_the_published_order():
    # ~190 GFLOPs a view of TimeSformer-B 8x224 (Bertasius et al.: 0.59
    # TFLOPs over 3 views)
    cfg = _config("timesformer_b16_divst_8x224")
    assert 180e9 < counts.fwd_flops(cfg, 1) / 1 < 400e9
    calls = counts.kernel_calls(cfg, 8 * 3, backward=False)
    assert len(calls) == 36  # B1 twice and B2 once a layer
    assert len(counts.kernel_calls(cfg, 16, backward=True)) == 72


def test_mvit_schedule_and_flops():
    cfg = _config("mvit_b_maskfeat_16x224")
    blocks = counts.mvit_blocks(cfg)
    assert [b["dim"] for b in blocks] == [96] + [192] * 2 + [384] * 11 + \
        [768] * 2
    assert [b["heads"] for b in blocks] == [1] + [2] * 2 + [4] * 11 + [8] * 2
    assert blocks[-1]["thw"] == (8, 14, 14)
    assert blocks[0]["stride_kv"] == [1, 8, 8]
    assert blocks[3]["stride_kv"] == [1, 2, 2]
    # MViT-B 16x4: 70.5 GFLOPs (multiply-adds) a view in Fan et al.
    flops = counts.mvit_fwd_flops(cfg, 1)
    assert 120e9 < flops < 180e9
    calls = counts.kernel_calls(cfg, 16, backward=True)
    # B5 and B6 in all 16 blocks, B2 and B4 where the width stays
    assert len(calls) == 16 * 2 + 13 * 2
