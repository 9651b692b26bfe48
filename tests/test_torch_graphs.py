"""CUDA graphs of the eval frame (models/graphs.py) and the sync-free
constants they need.

On the CPU: the cached constants (utils/constants.py) follow the device
and dtype and give voxel coords and the head's RV maths bit-equal to the
`torch.tensor` constants they replace; every path that cannot replay (the
CPU, train mode, the gather encoder) counts its segments as `graph.eager`
and none as `graph.replayed`; a ResNet camera branch adds two segments an
agent; the graph cache's keys follow the weights.

On the card (marker `cuda`, the small fusion detector in float32): replays
against eager frames on two different frames (also with a ResNet-50
camera branch, which replays too), after in-place weight copies
and `load_state_dict`, at a new batch shape; a replayed frame under
`set_sync_debug_mode("error")`; kernel 3 still called on the host, once a
decoder layer and agent, and the head's kernel 4 once an agent. Run
there with `python -m pytest tests/test_torch_graphs.py -m cuda
--noconftest -q`.
"""
from __future__ import annotations

import pytest
import torch

from cmtcoop_tpu_torch.configs.presets import (SMALL_FUSION_EXTRACTOR,
                                               SMALL_FUSION_HEAD,
                                               SMALL_FUSION_PRESET,
                                               SMALL_GATHER_EXTRACTOR,
                                               tiny_preset)
from cmtcoop_tpu_torch.core.boxes import normalize_01
from cmtcoop_tpu_torch.core.coder import decode_boxes
from cmtcoop_tpu_torch.data.synthetic import (small_fusion_batch,
                                              small_fusion_train_batch)
from cmtcoop_tpu_torch.models import layers, petr_decoder
from cmtcoop_tpu_torch.models.build import build_detector, random_init_
from cmtcoop_tpu_torch.models.detector import graphable
from cmtcoop_tpu_torch.models.graphs import MAX_KEYS, FrameGraphs
from cmtcoop_tpu_torch.ops.pillars import compute_voxel_coords
from cmtcoop_tpu_torch.train.train_step import step_generators
from cmtcoop_tpu_torch.utils import profiling
from cmtcoop_tpu_torch.utils.constants import constant

PRESET = tiny_preset(**SMALL_FUSION_PRESET)
COUNTERS = ("graph.replayed", "graph.eager")
# the same detector with a ResNet-50 camera branch, which runs as segments
R50 = dict(img_spec="r50", img_out_features=("layer3", "layer4"))


def fusion_model(seed: int = 2, **extractor):
    model = build_detector(PRESET,
                           extractor_kwargs=dict(SMALL_FUSION_EXTRACTOR,
                                                 **extractor),
                           head_kwargs=SMALL_FUSION_HEAD)
    random_init_(model, torch.Generator().manual_seed(seed))
    return model.eval()


def tensors(batch, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def counted(fn):
    """fn()'s result and the frame counters it added."""
    before = [profiling.total(k) for k in COUNTERS]
    out = fn()
    return out, [profiling.total(k) - b for k, b in zip(COUNTERS, before)]


# ------------------------------- on the CPU --------------------------------

def test_constants_follow_device_and_dtype():
    a = constant((1.0, 2.5, -3.0), torch.float32, "cpu")
    assert a is constant([1.0, 2.5, -3.0], torch.float32,
                         torch.device("cpu"))
    assert a.dtype == torch.float32 and a.device.type == "cpu"
    b = constant((1.0, 2.5, -3.0), torch.float64, "cpu")
    assert b.dtype == torch.float64 and b is not a
    assert torch.equal(b, torch.tensor((1.0, 2.5, -3.0), dtype=torch.float64))
    with torch.inference_mode():
        c = constant((7, 8), torch.long, "cpu")
    assert not c.is_inference()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_voxel_coords_and_rv_maths_bit_equal(dtype):
    """The cached constants give what `torch.tensor` constants built at
    each call gave, bit for bit."""
    g = torch.Generator().manual_seed(3)
    pts = (torch.rand(4000, 5, generator=g, dtype=dtype) - 0.5) * 40
    mask = torch.rand(4000, generator=g) > 0.1
    vs, pcr, gs = (0.1, 0.1, 0.2), (-16.0, -16.0, -5.0, 16.0, 16.0, 5.0), \
        (320, 320, 50)
    lo = torch.tensor(pcr[:3], dtype=dtype)
    gxyz = torch.floor((pts[..., :3] - lo) / torch.tensor(vs, dtype=dtype)
                       ).long()
    valid = mask & (gxyz >= 0).all(-1) & (gxyz < torch.tensor(gs)).all(-1)
    zyx, ok = compute_voxel_coords(pts, mask, vs, pcr, gs)
    assert torch.equal(zyx, gxyz.flip(-1)) and torch.equal(ok, valid)
    hi = torch.tensor(pcr[3:], dtype=dtype)
    assert torch.equal(normalize_01(pts[:, :3], pcr),
                       (pts[:, :3] - lo) / (hi - lo))

    head = fusion_model().pts_bbox_head
    ref01 = torch.rand(1, 50, 3, generator=g)
    l2i = tensors(small_fusion_batch())["infrastructure_lidar2img"]
    lo = ref01.new_tensor(head.pc_range[:3])
    hi = ref01.new_tensor(head.pc_range[3:])
    p = ref01 * (hi - lo) + lo
    proj = torch.einsum("bnd,bvcd->bvnc",
                        torch.cat([p, torch.ones_like(p[..., :1])], -1), l2i)
    z = proj[..., 2:3]
    uvz = torch.cat([proj[..., :3] / (z + torch.where(z > 0, 1e-6, -1e-6)),
                     proj[..., 3:]], -1)
    got_uvz, _ = head.project_queries(ref01, l2i, (64, 128))
    assert torch.equal(got_uvz, uvz)


def test_paths_that_cannot_replay_count_eager_segments():
    """The CPU, train mode and the gather encoder run every segment on
    the host: `graph.eager`, never `graph.replayed`; `graphable` says why
    for each but the device."""
    model = fusion_model()
    exts = [model.vehicle_model, model.infrastructure_model]
    batch = tensors(small_fusion_batch())
    with torch.no_grad():
        assert graphable(model, exts)
        _, (replayed, eager) = counted(lambda: model(batch))
    assert replayed == 0 and eager > 0
    assert not graphable(model, exts)  # autograd on
    model.train()
    with torch.no_grad():
        assert not graphable(model, exts)
    _, (replayed, eager) = counted(lambda: model(
        tensors(small_fusion_train_batch()), step_generators(0, 0)))
    assert replayed == 0 and eager > 0
    gather = fusion_model(**SMALL_GATHER_EXTRACTOR)
    with torch.no_grad():
        assert not graphable(gather, [gather.vehicle_model,
                                      gather.infrastructure_model])
        _, (replayed, eager) = counted(lambda: gather(batch))
    assert replayed == 0 and eager > 0


def test_a_resnet_camera_runs_as_segments():
    """A ResNet camera branch is two segments an agent (its backbone and
    its neck), a VoVNet one none (it stays on the host); on the CPU both
    run eager."""
    batch = tensors(small_fusion_batch())
    with torch.no_grad():
        _, (_, vovnet_n) = counted(lambda: fusion_model()(batch))
        _, (replayed, resnet_n) = counted(
            lambda: fusion_model(**R50)(batch))
    assert replayed == 0 and resnet_n == vovnet_n + 2 * 2


def test_eval_segments_equal_the_decoder_forward():
    """The eval decoder's segments (`eval_forward`, eager) compute what the
    decoder's layer loop computes in eval, bit for bit: one layer body."""
    decoder = fusion_model().pts_bbox_head.transformer.decoder
    g = torch.Generator().manual_seed(4)
    memory, memory_pos = (torch.randn(1, 96, 32, generator=g)
                          for _ in range(2))
    query_pos = torch.randn(1, 20, 32, generator=g)
    with torch.no_grad():
        want = decoder(torch.zeros_like(query_pos), memory, query_pos,
                       memory_pos)
        got = decoder.eval_forward(memory, query_pos, memory_pos)
    assert got.shape == want.shape and torch.equal(got, want)


def test_graph_keys_follow_weights_and_shapes():
    """A key's first frame runs eager; a weight copied in place or loaded
    by `load_state_dict` makes a new key and drops the stale ones; another
    batch shape is a key of its own, the oldest dropped past the bound."""
    model = fusion_model()
    mods = [model.pts_bbox_head]
    graphs = FrameGraphs()
    batch = tensors(small_fusion_batch())
    assert graphs.frame(batch, mods, graphable=True).mode == "eager"
    assert len(graphs.tapes) == 1
    with torch.no_grad():
        model.pts_bbox_head.reference_points.weight.add_(0.0)
    graphs.frame(batch, mods, graphable=True)
    model.pts_bbox_head.load_state_dict(model.pts_bbox_head.state_dict())
    key = graphs.frame(batch, mods, graphable=True)
    assert len(graphs.tapes) == 1
    for n in range(2, MAX_KEYS + 2):
        wide = {k: torch.cat([v] * n) for k, v in batch.items()}
        assert graphs.frame(wide, mods, graphable=True).mode == "eager"
    assert len(graphs.tapes) == MAX_KEYS and key.key not in graphs.tapes
    assert graphs.frame(batch, mods, graphable=False).mode == "eager"
    assert len(graphs.tapes) == MAX_KEYS


# ------------------------------- on the card -------------------------------

def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (on the card: python -m "
                    "pytest tests/test_torch_graphs.py -m cuda --noconftest)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def two_frames(dev):
    """The small fusion batch and another frame: its clouds shrunk by 0.9
    with other intensities, its images mirrored."""
    a = small_fusion_batch()
    b = {k: v.copy() for k, v in a.items()}
    for agent in ("vehicle_", "infrastructure_"):
        b[agent + "points"][..., :3] *= 0.9
        b[agent + "points"][..., 3] = 1.0 - b[agent + "points"][..., 3]
        b[agent + "imgs"] = b[agent + "imgs"][:, :, :, ::-1].copy()
    return tensors(a, dev), tensors(b, dev)


def serve(model, batch):
    """One eval forward (`run_eval`'s: autograd off) -> the task outputs."""
    with torch.no_grad():
        return model(batch)[0]


def eager(model, batch):
    """The forward as a fresh graph cache's first frame: eager."""
    saved, model.graphs = model.graphs, FrameGraphs()
    try:
        return serve(model, batch)
    finally:
        model.graphs = saved


# Two scores this close are one tie: a frame's float32 atomics (the pillar
# means) move the small detector's scores by up to 1.2e-7 between two eager
# frames, and its random weights give runs of scores 6e-8 apart, whose boxes
# then swap ranks.
TIE = 1e-6


def assert_same(got, ref, tol=1e-4):
    """Within the rounding of the pillar means' float32 atomics; the
    decoded top-k alike: the scores rank by rank, and each box one of the
    reference's whose score ties with the reference score at its rank (to
    `TIE`), each reference box matched once."""
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in r:
            torch.testing.assert_close(g[k], r[k], rtol=tol, atol=tol)
    for b in range(ref[0]["cls_logits"].shape[1]):
        mine, want = [decode_boxes(
            [t["cls_logits"][-1, b]],
            [torch.cat([t[k][-1, b] for k in ("center", "height", "dim",
                                             "rot", "vel")], -1)])
            for t in (got[0], ref[0])]
        torch.testing.assert_close(mine.scores, want.scores, rtol=tol,
                                   atol=tol)
        free = set(range(len(want.boxes)))
        for i, box in enumerate(mine.boxes):
            tied = [j for j in sorted(free) if abs(float(
                want.scores[j] - want.scores[i])) <= TIE]
            match = [j for j in tied if torch.allclose(
                box, want.boxes[j], rtol=tol, atol=tol)]
            assert match, (f"rank {i}: scores "
                           f"{want.scores[max(i - 2, 0):i + 3].tolist()}, "
                           f"box {box.tolist()}")
            free.remove(match[0])


@pytest.mark.cuda
@pytest.mark.parametrize("backbone", [{}, R50], ids=["vovnet", "resnet"])
def test_replay_follows_each_frame(backbone):
    dev = card()
    model = fusion_model(**backbone).to(dev)
    a, b = two_frames(dev)
    ref_a, ref_b = eager(model, a), eager(model, b)
    assert not torch.allclose(ref_a[0]["cls_logits"], ref_b[0]["cls_logits"])
    got = []
    for batch in (a, a, b, a, b):  # eager, capture, then replays
        out, (replayed, eager_n) = counted(lambda: serve(model, batch))
        got.append((out, replayed, eager_n))
    assert [r for _, r, _ in got[:2]] == [0, 0]
    assert all(r > 0 and e == 0 for _, r, e in got[2:])
    for (out, _, _), ref in zip(got, (ref_a, ref_a, ref_b, ref_a, ref_b)):
        assert_same(out, ref)
    # the result is the frame's own, not the pool's
    assert not torch.equal(got[3][0][0]["cls_logits"],
                           got[4][0][0]["cls_logits"])
    assert model.graphs.pool_bytes() > 0


@pytest.mark.cuda
def test_replay_follows_new_weights():
    """After the harness's in-place copy of every weight, and after
    `load_state_dict`, the next frames follow the new weights."""
    dev = card()
    model = fusion_model().to(dev)
    a, b = two_frames(dev)
    for _ in range(3):
        serve(model, a)
    other = fusion_model(seed=5).to(dev)
    with torch.no_grad():
        for t, src in zip(model.state_dict(keep_vars=True).values(),
                          other.state_dict().values()):
            t.copy_(src)
    ref = eager(other, b)
    for _ in range(3):  # eager, capture, replay
        assert_same(serve(model, b), ref)
    third = fusion_model(seed=7).to(dev)
    model.load_state_dict(third.state_dict())
    ref = eager(third, a)
    for _ in range(3):
        assert_same(serve(model, a), ref)
    assert len(model.graphs.tapes) == 1


@pytest.mark.cuda
def test_a_new_shape_captures_anew():
    dev = card()
    model = fusion_model().to(dev)
    a, b = two_frames(dev)
    pair = {k: torch.cat([a[k], b[k]]) for k in a}
    for _ in range(3):
        serve(model, a)
    ref = eager(model, pair)
    counts = []
    for _ in range(3):
        out, n = counted(lambda: serve(model, pair))
        assert_same(out, ref)
        counts.append(n[0])
    assert counts[:2] == [0, 0] and counts[2] > 0
    assert len(model.graphs.tapes) == 2
    _, n = counted(lambda: serve(model, a))  # the first key still replays
    assert n[0] > 0 and n[1] == 0


@pytest.mark.cuda
def test_a_replayed_frame_is_sync_free_and_calls_kernel_3(monkeypatch):
    """The wrappers the benchmark installs on kernel 3 and the head's
    kernel 4 still see every call of a replayed frame."""
    dev = card()
    model = fusion_model().to(dev)
    a, _ = two_frames(dev)
    for _ in range(2):
        serve(model, a)
    calls, convs = [], []

    def wrap(module, name, into):
        kernel = getattr(module, name)

        def wrapped(*args, **kwargs):
            into.append(tuple(args[0].shape))
            return kernel(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)

    wrap(petr_decoder, "flash_attention_packed", calls)
    wrap(layers, "conv3x3_bn_relu_packed", convs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            out, (replayed, eager_n) = counted(lambda: model(a))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert replayed > 0 and eager_n == 0
    depth = len(model.pts_bbox_head.transformer.decoder.layers)
    assert len(calls) == depth * len(model.agents)
    assert len(convs) == len(model.agents)
    assert torch.isfinite(out[0][0]["cls_logits"]).all()
