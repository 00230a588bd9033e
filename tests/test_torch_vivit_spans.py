"""The port's spans on ViViT's path (``utils/profiling.py``), on the CPU.

Inside a profiler session a ViViT joint forward records one
``vivit.embed`` span (the tubelet embedding and the token assembly) and,
where a clip passes ``blocks.FUSED_MHSA_MAX_N`` tokens, one
``attention.unfused`` span a layer around the unfused joint attention's
forward; at or below the cap the fused call runs and records none. With
no session nothing is recorded, and TimeSformer's forward (divided
attention) records neither span in a session. The model is ViViT's
published geometry at a small width (D 64, 2 heads, 2 layers), one clip
of 32 frames (3137 tokens) or 16 (1569) at 224².
"""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from videotransformer_tpu_torch.models.timesformer import TimeSformer
from videotransformer_tpu_torch.models.vivit import ViViT
from videotransformer_tpu_torch.ops import blocks
from videotransformer_tpu_torch.utils import profiling

LAYERS = 2
NAMES = ("vivit.embed", "attention.unfused")


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _vivit(frames):
    return ViViT(num_frames=frames, embed_dims=64, num_heads=2,
                 num_transformer_layers=LAYERS,
                 attention_type="joint_space_time").eval()


def _spans_of(forward):
    """The spans ``NAMES`` of a session around ``forward`` (the recorder
    still holds an earlier session's spans where this one records none:
    those begin before it)."""
    start = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.no_grad():
            forward()
    return [s for s in profiling.RECORDER.spans()
            if s.name in NAMES and s.start_ns >= start]


@pytest.mark.parametrize("frames,unfused", [(32, LAYERS), (16, 0)])
def test_a_joint_forward_records_its_spans(frames, unfused):
    net = _vivit(frames)
    tokens = 1 + 196 * frames // 2
    assert (tokens > blocks.FUSED_MHSA_MAX_N) == bool(unfused)
    video = torch.randn(1, frames, 3, 224, 224)
    spans = _spans_of(lambda: net(video))
    names = [s.name for s in spans]
    assert names.count("vivit.embed") == 1
    assert names.count("attention.unfused") == unfused
    (embed,) = [s for s in spans if s.name == "vivit.embed"]
    for s in spans:
        assert s.parent is None and s.events is None  # no card: no events
        assert s.start_ns <= s.end_ns
        if s.name == "attention.unfused":
            assert s.start_ns >= embed.end_ns


def test_no_session_records_nothing():
    net = _vivit(32)
    before = profiling.RECORDER.spans()
    with torch.no_grad():
        net(torch.randn(1, 32, 3, 224, 224))
    assert profiling.RECORDER.spans() == before


def test_timesformer_records_neither_span():
    net = TimeSformer(num_frames=8, img_size=224, embed_dims=64,
                      num_heads=2, num_transformer_layers=LAYERS).eval()
    assert _spans_of(lambda: net(torch.randn(1, 8, 3, 224, 224))) == []
