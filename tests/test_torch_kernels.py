"""The port's kernel wrappers: device dispatch and build plumbing on the CPU,
and each hand-written CUDA kernel against its plain version on the card.

This file imports torch and the port only (no jax), so the card's tests run
on a machine without jax:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

Tests marked `cuda` skip without a GPU. On the card float32 is compared
with TF32 off at max |kernel - plain| <= 1e-4 * max |plain| (summation
order only); bfloat16 at 2e-2 (output rounding, a few ulps).
"""

import itertools

import numpy as np
import pytest
import torch

from cmtcoop_tpu_torch import _build, main_path, profile_path
from cmtcoop_tpu_torch.core.coder import decode_boxes
from cmtcoop_tpu_torch.data.formats import decoded_to_eval_boxes
from cmtcoop_tpu_torch.train.eval_hook import make_eval_forward, to_device
from cmtcoop_tpu_torch.utils import profiling
from cmtcoop_tpu_torch.configs.presets import (SMALL_COOP_EXTRACTOR,
                                               SMALL_COOP_HEAD,
                                               SMALL_COOP_PRESET,
                                               SMALL_FUSION_EXTRACTOR,
                                               SMALL_GATHER_EXTRACTOR,
                                               SMALL_FUSION_HEAD,
                                               SMALL_FUSION_PRESET,
                                               get_preset, tiny_preset)
from cmtcoop_tpu_torch.data.synthetic import (small_coop_batch,
                                              small_fusion_batch)
from cmtcoop_tpu_torch.models.build import build_detector, random_init_
from cmtcoop_tpu_torch.models.resnet import ResNet
from cmtcoop_tpu_torch.ops import pillars as pu
from cmtcoop_tpu_torch.ops.attention import (
    NEG_INF, flash_attention_bwd, flash_attention_bwd_reference,
    flash_attention_kvmask, flash_attention_kvmask_reference,
    flash_attention_packed, flash_attention_packed_reference, wgmma_check)
from cmtcoop_tpu_torch.models.vovnet import OSAModule
from cmtcoop_tpu_torch.ops.conv_cf import (conv3x3_bn_relu,
                                           conv3x3_bn_relu_packed,
                                           conv3x3_bn_relu_reference,
                                           conv3x3_plan, osa_agg_plan,
                                           osa_agg_plans, osa_aggregate,
                                           osa_aggregate_packed,
                                           osa_aggregate_reference,
                                           pack_conv3x3_weight,
                                           pack_osa_weight, sm_count)
from cmtcoop_tpu_torch.ops import sparse_utils as su
from cmtcoop_tpu_torch.ops.lookup_kernel import (INT32_MAX, neighbor_map,
                                                 neighbor_map_reference,
                                                 sorted_lookup)
from cmtcoop_tpu_torch.models.sparse_encoder import SparseEncoder
from cmtcoop_tpu_torch.ops.pillar_fused import (active_rows,
                                                fold_occupancy,
                                                fused_pillar_conv,
                                                fused_pillar_conv_packed,
                                                fused_pillar_conv_reference,
                                                gather_wgmma_check,
                                                pack_pillar_weight, pin_rows,
                                                pillar_conv_plan,
                                                pin_rows_reference)

# the small cooperative detector of the slice tests (16x16 BEV, 2 stages)
SLICE_PRESET = tiny_preset(**SMALL_COOP_PRESET)
DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


def slice_model(agents=("vehicle", "infrastructure")):
    return build_detector(SLICE_PRESET,
                          extractor_kwargs=SMALL_COOP_EXTRACTOR,
                          head_kwargs=SMALL_COOP_HEAD, agents=agents)


def gather_slice_model():
    return build_detector(SLICE_PRESET,
                          extractor_kwargs=SMALL_GATHER_EXTRACTOR,
                          head_kwargs=SMALL_COOP_HEAD)


def fusion_slice_model():
    return build_detector(tiny_preset(**SMALL_FUSION_PRESET),
                          extractor_kwargs=SMALL_FUSION_EXTRACTOR,
                          head_kwargs=SMALL_FUSION_HEAD)


# ResNet-50's bf16 maps against the float32 plain path: they read 1.03%
# (layer3) and 0.90% (layer4) of the largest magnitude on the card
RESNET_BF16_TOL = 3e-2


def cuda_device():
    """The CUDA device, or skip. Turns TF32 off so the plain versions a
    kernel is held against run in full float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (on the card: python -m "
                    "pytest tests/test_torch_kernels.py -m cuda --noconftest)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, ref, tol):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got[1:], ref[1:]):
        assert torch.equal(g, r)
    _assert_rel(got[0], ref[0], tol)


def _assert_rel(got, ref, tol):
    """max |got - ref| <= tol * max |ref|, same shape."""
    g, r = got.float(), ref.float()
    assert g.shape == r.shape
    err = float((g - r).abs().max())
    assert err <= tol * float(r.abs().max()), err


# ------------------------------- on the CPU --------------------------------


def test_wrappers_refuse_devices_without_a_kernel():
    meta = torch.device("meta")
    x = torch.zeros(8, 4, 2, device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        fused_pillar_conv(x, torch.zeros(8, 9, dtype=torch.int32,
                                         device=meta),
                          torch.zeros(27, 2, 2, device=meta),
                          occ_out=torch.zeros(8, 4, dtype=torch.bool,
                                              device=meta))
    q = torch.zeros(1, 4, 8, device=meta)
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention_packed(q, q, q, None, 2)
    with pytest.raises(ValueError, match="no kernel"):
        conv3x3_bn_relu(torch.zeros(1, 3, 3, 2, device=meta),
                        torch.zeros(4, 2, 3, 3, device=meta),
                        torch.ones(4, device=meta),
                        torch.zeros(4, device=meta))
    with pytest.raises(ValueError, match="no kernel"):
        conv3x3_bn_relu(torch.zeros(1, 3, 3, 2, device=meta),
                        torch.zeros(4, 2, 3, 3, device=meta),
                        torch.ones(4, device=meta),
                        torch.zeros(4, device=meta),
                        residual=torch.zeros(1, 3, 3, 4, device=meta))
    with pytest.raises(ValueError, match="no kernel"):
        osa_aggregate([torch.zeros(1, 3, 3, 2, device=meta)] * 2,
                      torch.zeros(4, 5, device=meta),
                      torch.ones(5, device=meta), torch.zeros(5, device=meta))


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(0)
    before = dict(_build.launch_counts)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, n, 32)).astype(
        np.float32)) for n in (5, 7, 7))
    torch.testing.assert_close(
        flash_attention_packed(q, k, v, None, 4),
        flash_attention_packed_reference(q, k, v, torch.zeros(1, 7), 4))
    x = torch.from_numpy(rng.normal(size=(1, 4, 5, 3)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(6, 3, 3, 3)).astype(np.float32))
    torch.testing.assert_close(
        conv3x3_bn_relu(x, w, torch.ones(6), torch.zeros(6)),
        conv3x3_bn_relu_reference(x, w, torch.ones(6), torch.zeros(6)))
    r = torch.from_numpy(rng.normal(size=(1, 4, 5, 6)).astype(np.float32))
    got = conv3x3_bn_relu(x, w, torch.ones(6), torch.zeros(6), residual=r)
    torch.testing.assert_close(got, conv3x3_bn_relu_reference(
        x, w, torch.ones(6), torch.zeros(6), residual=r))
    assert not torch.equal(got, conv3x3_bn_relu(x, w, torch.ones(6),
                                                torch.zeros(6)))
    parts = [torch.from_numpy(rng.normal(size=(2, 4, 5, c)).astype(
        np.float32)) for c in (3, 2, 2)]
    wa = torch.from_numpy(rng.normal(size=(7, 6)).astype(np.float32))
    s, b = torch.full((6,), 0.5), torch.full((6,), 0.1)
    agg, gap = osa_aggregate(parts, wa, s, b)
    ref_agg, ref_gap = osa_aggregate_reference(parts, wa, s, b)
    torch.testing.assert_close(agg, ref_agg)
    torch.testing.assert_close(gap, ref_gap)
    torch.testing.assert_close(gap, agg.sum(dim=(1, 2)))
    assert _build.launch_counts == before


def test_train_attention_wrappers_on_cpu_and_other_devices():
    """Kernels 7 and 8 take their plain versions for CPU tensors (no launch)
    and refuse a device without a kernel."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, n, 8, generator=g) for n in (5, 7, 7))
    before = dict(_build.launch_counts)
    out, m, l = flash_attention_kvmask(q, k, v, None, True, 0.1, 3)
    ref = flash_attention_kvmask_reference(q, k, v, torch.zeros(1, 7), True,
                                           0.1, 3)
    for a, b in zip((out, m, l), ref):
        torch.testing.assert_close(a, b)
    grads = flash_attention_bwd(q, k, v, torch.zeros(1, 7), out, m, l,
                                torch.ones_like(out), 0.1, 3)
    assert [tuple(t.shape) for t in grads] == [(1, 2, 5, 8), (1, 2, 7, 8),
                                              (1, 2, 7, 8), (1, 7)]
    no_kb = flash_attention_bwd(q, k, v, torch.zeros(1, 7), out, m, l,
                                torch.ones_like(out), 0.1, 3, False)
    assert no_kb[3] is None
    for a, b in zip(no_kb[:3], grads):
        torch.testing.assert_close(a, b)
    assert _build.launch_counts == before
    meta = torch.zeros(1, 2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention_kvmask(meta, meta, meta, None)
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention_bwd(meta, meta, meta, None, meta, None, None, meta)


def test_library_is_keyed_by_sources_and_flags(monkeypatch):
    a = _build.library_path()
    assert a.parent == _build.BUILD_DIR and a.suffix == ".so"
    assert _build.library_path() == a
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path() != a
    assert {p.name for p in _build.sources()} >= {
        "pillar_conv.cu", "flash_attention.cu", "conv3x3.cu", "osa_agg.cu",
        "flash_train.cu", "sorted_lookup.cu", "rows_copy.cu", "common.cuh"}


def _lookup_case(g, n_keys, n_q, tail):
    """Sorted distinct int32 keys with a sentinel tail; queries in random
    order: keys and the values around them, sentinels in the middle."""
    keys = torch.randperm(4 * n_keys + 8, generator=g)[:n_keys].sort().values
    keys = torch.cat([keys, torch.full((tail,), INT32_MAX)]).int()
    pool = torch.cat([keys, torch.arange(-2, 4 * n_keys + 10)]).int()
    q = pool[torch.randint(0, len(pool), (n_q,), generator=g)]
    q[torch.rand(n_q, generator=g) < 0.1] = INT32_MAX
    return keys, q


def test_lookup_and_pin_rows_wrappers_on_cpu_and_other_devices():
    """Kernels 9 and 10 take their plain versions for CPU tensors (no
    launch) and refuse a device without a kernel."""
    g = torch.Generator().manual_seed(0)
    keys, q = _lookup_case(g, 50, 300, 6)
    before = dict(_build.launch_counts)
    pos, hit = sorted_lookup(keys, q, run=2)
    assert pos.shape == hit.shape == (300, 2)
    kl = keys.tolist()
    for j, qj in enumerate(q.tolist()):
        for d in range(2):
            t = qj if qj == INT32_MAX else qj + d
            assert int(pos[j, d]) == sum(k < t for k in kl)
            assert bool(hit[j, d]) == (qj != INT32_MAX and t in kl)
    assert hit.any() and not hit.all()
    x = torch.randn(7, 5)
    y = pin_rows(x)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    assert _build.launch_counts == before
    meta = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        sorted_lookup(meta, meta)
    with pytest.raises(ValueError, match="no kernel"):
        pin_rows(torch.zeros(4, 4, device="meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if (_build.Path("/usr/local/cuda") / "bin" / "nvcc").exists():
        pytest.skip("this machine has a CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_launch_counts_reset():
    _build.count("conv3x3_bn_relu")
    assert _build.launch_counts["conv3x3_bn_relu"] >= 1
    _build.reset_counts()
    assert set(_build.launch_counts.values()) == {0}
    assert tuple(_build.launch_counts) == _build.KERNELS


def test_launch_shapes_counted_beside_launches_and_reset():
    """A wrapper that names its shape adds one to its count and one to that
    (kernel, shape)'s; a reset clears both."""
    _build.reset_counts()
    for shape in ((1, 20, 50, 224, 224), (3, 40, 100, 192, 192),
                  (1, 20, 50, 224, 224)):
        _build.count("conv3x3_bn_relu", shape)
    _build.count("osa_aggregate")
    assert _build.launch_counts["conv3x3_bn_relu"] == 3
    assert dict(_build.launch_shapes) == {
        ("conv3x3_bn_relu", (1, 20, 50, 224, 224)): 2,
        ("conv3x3_bn_relu", (3, 40, 100, 192, 192)): 1}
    _build.reset_counts()
    assert not _build.launch_shapes
    assert set(_build.launch_counts.values()) == {0}


def test_profile_summary_reads_one_trace():
    """Idle share, stage and kernel device times from a hand-made trace of
    two 100 us frames (Chrome trace times in us)."""
    def ev(cat, name, ts, dur, corr=None):
        return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur,
                    args={} if corr is None else {"correlation": corr})
    trace = {"traceEvents": [
        ev("user_annotation", "frame", 0, 100),
        ev("user_annotation", "frame", 200, 100),
        ev("user_annotation", "decoder", 10, 40),
        ev("user_annotation", "pillarize", 210, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 20, 1, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 60, 1, corr=3),
        ev("cuda_driver", "cuLaunchKernel", 215, 1, corr=2),
        ev("kernel", "attn", 30, 40, corr=1),
        ev("gpu_memcpy", "copy", 60, 20, corr=3),   # overlaps attn
        ev("kernel", "sort", 250, 70, corr=2),      # runs past the frame
        ev("kernel", "sort", 150, 10, corr=4),      # between the frames
        {"ph": "i", "name": "marker", "ts": 5},
    ]}
    got = profile_path.summarize(trace, 2)
    assert got["frame_ms"] == pytest.approx(0.1)
    assert got["device_busy_ms"] == pytest.approx(0.05)  # (50 + 50) / 2
    assert got["idle_share"] == pytest.approx(0.5)
    assert got["stage_device_ms"] == pytest.approx(
        {"pillarize": 0.035, "decoder": 0.02, "other": 0.01})
    assert got["top_kernels_ms"] == pytest.approx(
        {"sort": 0.035, "attn": 0.02, "copy": 0.01})
    with pytest.raises(ValueError, match="frame spans"):
        profile_path.summarize(trace, 3)


def test_profile_summary_train_stages():
    """The train trace's stages: device time charged to the innermost
    span (a forward stage inside `forward`), host span per stage, and
    kernels 7 and 8 picked out by name (their tensor-core passes too)."""
    def ev(cat, name, ts, dur, corr=None):
        return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur,
                    args={} if corr is None else {"correlation": corr})
    trace = {"traceEvents": [
        ev("user_annotation", "frame", 0, 1000),
        ev("user_annotation", "forward", 0, 400),
        ev("user_annotation", "decoder", 100, 200),
        ev("user_annotation", "loss + Hungarian", 400, 100),
        ev("user_annotation", "backward", 500, 400),
        ev("cuda_runtime", "cudaLaunchKernel", 50, 1, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 150, 1, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 600, 1, corr=3),
        ev("cuda_runtime", "cudaLaunchKernel", 650, 1, corr=4),
        ev("kernel", "conv", 60, 30, corr=1),
        ev("kernel", "fwd_tc::fwd_kernel<true>", 160, 100, corr=2),
        ev("kernel", "flash_train_bwd_dkv_kernel<bf16>", 610, 200, corr=3),
        ev("kernel", "bwd_tc::dq_kernel<true>", 810, 100, corr=4),
    ]}
    got = profile_path.summarize(
        trace, 1, profile_path.STAGES + profile_path.TRAIN_STAGES)
    assert got["stage_device_ms"] == pytest.approx(
        {"forward": 0.03, "decoder": 0.1, "backward": 0.3})
    assert got["stage_host_ms"] == pytest.approx(
        {"forward": 0.4, "decoder": 0.2, "loss + Hungarian": 0.1,
         "backward": 0.4})
    assert got["train_kernels_ms"] == pytest.approx(
        {"fwd_tc::fwd_kernel<true>": 0.1,
         "flash_train_bwd_dkv_kernel<bf16>": 0.2,
         "bwd_tc::dq_kernel<true>": 0.1})
    assert got["idle_share"] == pytest.approx(0.57)


def test_profile_summary_sums_kernel_families():
    """Each kernel's instantiations summed under its name without `void`,
    template arguments or parameters (kernel 4's bf16 instantiations are
    one `conv_tc::conv3x3_tc_kernel`, kernel 6's one
    `osa_tc::osa_agg_tc_kernel` beside its gap reduction)."""
    trace = {"traceEvents": [
        dict(ph="X", cat="user_annotation", name="frame", ts=0, dur=100)] + [
        dict(ph="X", cat="kernel", name=name, ts=ts, dur=dur, args={})
        for name, ts, dur in (
            ("void conv_tc::conv3x3_tc_kernel<192, 1, false>(CUtensorMap_st)",
             0, 10),
            ("void conv_tc::conv3x3_tc_kernel<256, 2, true>(CUtensorMap_st)",
             10, 20),
            ("void osa_tc::osa_agg_tc_kernel<192>(osa_tc::Maps, OsaChans, "
             "float const*, __nv_bfloat16*, float*, int, int, int, int)",
             30, 25),
            ("void osa_tc::osa_agg_tc_kernel<64>(osa_tc::Maps, OsaChans, "
             "float const*, __nv_bfloat16*, float*, int, int, int, int)",
             55, 4),
            ("void osa_tc::osa_agg_tc_kernel<128>(osa_tc::Maps, OsaChans, "
             "float const*, __nv_bfloat16*, float*, int, int, int, int)",
             59, 1),
            ("osa_gap_kernel(float const*, float*, int, int, int)", 60, 1),
            ("Memset (Device)", 61, 5))]}
    got = profile_path.summarize(trace, 1)
    assert got["top_kernel_families_ms"] == pytest.approx(
        {"conv_tc::conv3x3_tc_kernel": 0.03,
         "osa_tc::osa_agg_tc_kernel": 0.03, "osa_gap_kernel": 0.001,
         "Memset": 0.005})
    assert profile_path.kernel_family("at::native::f<8>(int)") == \
        "at::native::f"


def _serve(model, host):
    """The per-batch body of `run_eval` on one host batch: boxes, and the
    forward's outputs."""
    logits, codes = make_eval_forward(model)(to_device(host, "cpu"))
    dec = decode_boxes([lg[0] for lg in logits], [c[0] for c in codes])
    return decoded_to_eval_boxes(dec, ("car",) * 10, 0), (logits, codes)


def test_profile_spans_leave_the_model_unchanged():
    """The program's own spans (no wrapping) sit in a profiler's trace:
    every stage of the fusion detector, the eval entry's and pillarize's;
    the answers with the spans recording are those without."""
    model = fusion_slice_model().eval()
    random_init_(model, torch.Generator().manual_seed(2))
    host = small_fusion_batch()
    ref_boxes, ref = _serve(model, host)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got_boxes, got = _serve(model, host)
    names = {e.key for e in prof.key_averages()}
    assert set(profile_path.STAGES) <= names
    assert {"eval.to_device", "eval.decode", "eval.boxes", "eval.readback",
            "pillarize.sort", "pillarize.slots", "pillarize.means"} <= names
    assert got_boxes == ref_boxes
    for o, r in zip(got, ref):
        for key in range(len(r)):
            torch.testing.assert_close(o[key], r[key], rtol=0, atol=0)


def test_profile_gather_spans_leave_the_model_unchanged():
    """The gather encoder's stages (voxelize, sparse maps, sparse convs)
    get their spans, and the spans change nothing."""
    model = gather_slice_model()
    random_init_(model, torch.Generator().manual_seed(2))
    batch = {k: torch.from_numpy(v) for k, v in small_coop_batch().items()}
    with torch.inference_mode():
        ref, _ = model(batch)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            got, _ = model(batch)
    names = {e.key for e in prof.key_averages()}
    assert set(profile_path.GATHER_STAGES) <= names
    assert "pillarize" not in names
    for o, r in zip(got, ref):
        for key in r:
            torch.testing.assert_close(o[key], r[key], rtol=0, atol=0)


def test_profile_summary_counts_launches_and_syncs_per_stage():
    """Device ops (kernels, copies, memsets) counted per stage by the span
    that launched them, host synchronize calls by the span they sit in,
    per frame; a map span inside the encoder's takes its own."""
    def ev(cat, name, ts, dur, corr=None):
        return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur,
                    args={} if corr is None else {"correlation": corr})
    trace = {"traceEvents": [
        ev("user_annotation", "frame", 0, 100),
        ev("user_annotation", "pillar encoder", 10, 80),
        ev("user_annotation", "pillar maps", 20, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 25, 1, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 30, 1, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 50, 1, corr=3),
        ev("cuda_runtime", "cudaMemcpyAsync", 60, 1, corr=4),
        ev("cuda_runtime", "cudaStreamSynchronize", 61, 5),
        ev("cuda_runtime", "cudaDeviceSynchronize", 95, 3),
        ev("cuda_runtime", "cudaDeviceSynchronize", 150, 3),  # no frame
        ev("kernel", "nmap::neighbor_map_kernel", 26, 2, corr=1),
        ev("kernel", "nmap::neighbor_map_kernel", 31, 2, corr=2),
        ev("kernel", "sort", 51, 5, corr=3),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 62, 1,
           corr=4),
    ]}
    got = profile_path.summarize(trace, 1)
    assert got["stage_launches"] == {"pillar maps": 2, "pillar encoder": 2}
    assert got["stage_syncs"] == {"pillar encoder": 1, "other": 1}
    assert got["stage_host_ms"]["pillar maps"] == pytest.approx(0.02)
    assert got["stage_device_ms"]["pillar maps"] == pytest.approx(0.004)


def test_profile_pillar_map_spans_leave_the_model_unchanged():
    """The pillar encoder's map builders run in a `pillar maps` span a
    call (a subm map a level and a down map between levels, per agent),
    in the profiler's trace and in the traced book, and the spans change
    nothing."""
    model = slice_model()
    random_init_(model, torch.Generator().manual_seed(2))
    batch = {k: torch.from_numpy(v) for k, v in small_coop_batch().items()}
    with torch.inference_mode():
        ref, _ = model(batch)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            got, _ = model(batch)
    counts = {e.key: e.count for e in prof.key_averages()}
    n_levels = len(model.vehicle_model.pts_middle_encoder.encoder_channels)
    assert counts[profile_path.PILLAR_MAPS] == 2 * (2 * n_levels - 1)
    assert profiling.traced_calls(profile_path.PILLAR_MAPS) == \
        2 * (2 * n_levels - 1)
    for o, r in zip(got, ref):
        for key in r:
            torch.testing.assert_close(o[key], r[key], rtol=0, atol=0)


def test_single_agent_detector_equals_coop_vehicle_only():
    """CmtDetector (extractor modules at the top level) and the coop
    detector degraded to the vehicle agent compute the same function."""
    import dataclasses
    coop = slice_model(("vehicle",))
    random_init_(coop, torch.Generator().manual_seed(1))
    single = build_detector(dataclasses.replace(SLICE_PRESET,
                                                domain="vehicle"),
                            extractor_kwargs=SMALL_COOP_EXTRACTOR,
                            head_kwargs=SMALL_COOP_HEAD)
    single.load_state_dict({k.replace("vehicle_model.", ""): v
                            for k, v in coop.state_dict().items()},
                           strict=True)
    b = {k: torch.from_numpy(v) for k, v in small_coop_batch().items()
         if k.startswith("vehicle_")}
    with torch.inference_mode():
        ref, _ = coop(b)
        got, _ = single({k[len("vehicle_"):]: v for k, v in b.items()})
    for o, r in zip(got, ref):
        for key in r:
            torch.testing.assert_close(o[key], r[key], rtol=0, atol=0)


def test_detector_settings_without_effect_and_the_resnet_backbone():
    """`use_grid_mask` (training only) and `img_impl` (a TPU layout switch)
    are accepted and change nothing; a ResNet `img_spec` builds ResNet-50
    + CPFPN over layer3 and layer4, and its detector loads another's
    state_dict strictly (the full `cmt_fusion_r50_nuscenes` built on the
    meta device, the small coop detector with that backbone filled)."""
    ref = fusion_slice_model()
    random_init_(ref, torch.Generator().manual_seed(3))
    other = build_detector(tiny_preset(**SMALL_FUSION_PRESET),
                           extractor_kwargs=dict(SMALL_FUSION_EXTRACTOR,
                                                 use_grid_mask=True,
                                                 img_impl="xla"),
                           head_kwargs=SMALL_FUSION_HEAD)
    other.load_state_dict(ref.state_dict(), strict=True)
    b = {k: torch.from_numpy(v) for k, v in small_fusion_batch().items()}
    with torch.inference_mode():
        for o, r in zip(other(b)[0], ref(b)[0]):
            for key in r:
                torch.testing.assert_close(o[key], r[key], rtol=0, atol=0)
    with torch.device("meta"):
        full = build_detector(get_preset("cmt_fusion_r50_nuscenes"),
                              dtype=torch.bfloat16)
    assert isinstance(full.img_backbone, ResNet)
    assert [tuple(m.conv.weight.shape) for m in
            full.img_neck.lateral_convs] == [(256, 1024, 1, 1),
                                             (256, 2048, 1, 1)]
    assert full.grid_size == (1024, 1024, 40)
    r50 = dict(SMALL_FUSION_EXTRACTOR, img_spec="r50",
               img_out_features=("layer3", "layer4"))
    src, dst = (build_detector(tiny_preset(**SMALL_FUSION_PRESET),
                               extractor_kwargs=r50,
                               head_kwargs=SMALL_FUSION_HEAD)
                for _ in range(2))
    random_init_(src, torch.Generator().manual_seed(4))
    sd = src.state_dict()
    assert "vehicle_model.img_backbone.layer4.2.conv3.weight" in sd
    assert ("infrastructure_model.img_backbone.layer1.0.downsample.1."
            "running_var") in sd
    dst.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        for o, r in zip(dst(b)[0], src(b)[0]):
            for key in r:
                torch.testing.assert_close(o[key], r[key], rtol=0, atol=0)


# ------------------------------- on the card -------------------------------


def _pillar_inputs(dev, dtype, z=9, c=16):
    g = torch.Generator().manual_seed(0)
    h = w = 32
    occ_bev = torch.rand(h, w, generator=g) < 0.35
    ys, xs = torch.nonzero(occ_bev, as_tuple=True)
    n = min(len(ys), 256)
    coords = torch.full((256, 2), -1, dtype=torch.int32)
    coords[:n, 0], coords[:n, 1] = ys[:n].int(), xs[:n].int()
    mask = torch.arange(256) < n
    grid = pu.PillarGrid(coords.to(dev), mask.to(dev), (h, w), z)
    occ = ((torch.rand(256, z, generator=g) < 0.5) & mask[:, None]).to(dev)
    x = (torch.randn(256, z, c, generator=g).to(dev) * occ[..., None])
    w9 = torch.randn(27, c, c, generator=g).to(dev) * 0.1
    s = (1 + 0.1 * torch.randn(c, generator=g)).to(dev)
    b = (0.1 * torch.randn(c, generator=g)).to(dev)
    return grid, occ, x.to(dtype), w9, s, b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("case", ["subm_residual", "down_fold_occ",
                                  "conv_out_kb1"])
def test_pillar_kernels_match_plain(dtype, tol, case):
    dev = cuda_device()
    grid, occ, x, w9, s, b = _pillar_inputs(dev, dtype)
    kw = dict(scale=s, bias=b, relu=True)
    if case == "subm_residual":
        nbr = pu.pillar_neighbor_map(grid)
        kw.update(occ_out=occ, residual=torch.flip(x, (0,)).contiguous()
                  * occ[..., None])
        w = w9
    elif case == "down_fold_occ":
        nbr = pu.pillar_conv_neighbor_map(
            grid, pu.pillar_downsample_grid(grid, 128))
        kw.update(z_stride=2, occ_in=occ, fold_occ=True)
        w = w9
    else:
        nbr = pu.identity_map(grid)
        kw.update(z_stride=2, z_pad=0,
                  occ_out=pu.occ_downsample(occ, nbr, 3, 2, 0))
        w = w9[:3]
    before = _build.launch_counts["pillar_conv_kb9" if nbr.shape[1] == 9
                                  else "pillar_conv_kb1"]
    got = fused_pillar_conv(x, nbr, w, **kw)
    ref = fused_pillar_conv_reference(x, nbr, w, **kw)
    _assert_close(got, ref, tol)
    after = _build.launch_counts["pillar_conv_kb9" if nbr.shape[1] == 9
                                 else "pillar_conv_kb1"]
    assert after == before + 1


# the pillar encoder's convs at reduced P: (kind, Cin, Cout); kinds
# "input" (no residual), "subm" (with a residual), "down" (stride 2, z pad
# 1), "down0" (the last down conv's z pad 0), "out" (conv_out, KB 1)
PILLAR_TC_CASES = [("input", 5, 16), ("subm", 16, 16), ("down", 16, 32),
                   ("subm", 32, 32), ("down", 32, 64), ("subm", 64, 64),
                   ("down0", 64, 128), ("subm", 128, 128),
                   ("input", 128, 128), ("out", 128, 128)]


def _pillar_tc_case(dev, kind, cin, cout, seed=0, n=600, z=11):
    """(feats, nbr, packed, kwargs) of one conv on a random 48 x 48 BEV
    grid of `n` pillars (40% of them occupied at each z), bf16."""
    g = torch.Generator().manual_seed(seed)
    cells = torch.randperm(48 * 48, generator=g)[:n].sort().values
    p = n + 16  # padding rows past the pillars
    coords = torch.full((p, 2), -1, dtype=torch.int32)
    coords[:n, 0], coords[:n, 1] = (cells // 48).int(), (cells % 48).int()
    mask = torch.arange(p) < n
    grid = pu.PillarGrid(coords.to(dev), mask.to(dev), (48, 48), z)
    occ = ((torch.rand(p, z, generator=g) < 0.4) & mask[:, None]).to(dev)
    x = (torch.randn(p, z, cin, generator=g).to(dev)
         * occ[..., None]).to(torch.bfloat16)
    kb = 1 if kind == "out" else 9
    w = (torch.randn(3 * kb, cin, cout, generator=g)
         * (3 * kb * cin) ** -0.5).to(dev)
    s = (1 + 0.1 * torch.randn(cout, generator=g)).to(dev)
    b = (0.1 * torch.randn(cout, generator=g)).to(dev)
    kw = dict(relu=True)
    if kind in ("input", "subm"):
        nbr = pu.pillar_neighbor_map(grid)
        kw["occ_out"] = occ
        if kind == "subm":
            kw["residual"] = (torch.randn(p, z, cout, generator=g).to(dev)
                              * occ[..., None]).to(torch.bfloat16)
    elif kind == "out":
        nbr = pu.identity_map(grid)
        kw.update(z_stride=2, z_pad=0,
                  occ_out=pu.occ_downsample(occ, nbr, 3, 2, 0))
    else:
        nbr = pu.pillar_conv_neighbor_map(
            grid, pu.pillar_downsample_grid(grid, 400))
        kw.update(z_stride=2, z_pad=0 if kind == "down0" else 1,
                  occ_in=occ, fold_occ=True)
    return x, nbr, pack_pillar_weight(w, s, b, torch.bfloat16), kw


@pytest.mark.cuda
@pytest.mark.parametrize("kind,cin,cout", PILLAR_TC_CASES)
def test_pillar_tc_kernel_matches_plain(kind, cin, cout):
    """Kernels 1 and 2's bf16 route (wgmma, A gathered by cp.async) at
    each Cin -> Cout of the pillar encoder and at KB 1, against the plain
    version; two calls bit-equal."""
    dev = cuda_device()
    x, nbr, packed, kw = _pillar_tc_case(dev, kind, cin, cout)
    ref = fused_pillar_conv_reference(x, nbr, packed.source, kz=3,
                                      scale=packed.scale, bias=packed.bias,
                                      **kw)
    name = "pillar_conv_kb1" if kind == "out" else "pillar_conv_kb9"
    before = _build.launch_counts[name]
    got = fused_pillar_conv_packed(x, nbr, packed, **kw)
    _assert_close(got, ref, 2e-2)
    again = fused_pillar_conv_packed(x, nbr, packed, **kw)
    for a, b in zip(got if kw.get("fold_occ") else (got,),
                    again if kw.get("fold_occ") else (again,)):
        assert torch.equal(a, b)
    assert _build.launch_counts[name] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(16, 16), (128, 128)])
def test_pillar_tc_kernel_walks_many_tiles_a_block(cin, cout):
    """More occupied rows than the persistent grid has blocks times rows a
    tile (128 at Cout 16, 64 at Cout 128), so each block walks several
    tiles and its ring runs on across them: against the plain version, two
    calls bit-equal."""
    dev = cuda_device()
    x, nbr, packed, kw = _pillar_tc_case(dev, "subm", cin, cout, n=2304,
                                         z=64)
    plan = pillar_conv_plan(9, 3, cin, cout, x.shape[0] * x.shape[1],
                            sm_count(dev))
    n_rows = int(kw["occ_out"].sum())
    assert -(-n_rows // plan.bm) > plan.grid
    got = fused_pillar_conv_packed(x, nbr, packed, **kw)
    ref = fused_pillar_conv_reference(x, nbr, packed.source, kz=3,
                                      scale=packed.scale, bias=packed.bias,
                                      **kw)
    _assert_close(got, ref, 2e-2)
    assert torch.equal(fused_pillar_conv_packed(x, nbr, packed, **kw), got)


@pytest.mark.cuda
def test_pillar_tc_kernel_on_shared_rows_and_empty_occupancy():
    """The encoder's call: a down conv's occupancy folded and compacted
    once, then passed in; an occupancy with no row leaves the output
    zero."""
    dev = cuda_device()
    x, nbr, packed, kw = _pillar_tc_case(dev, "down", 32, 64)
    occ = fold_occupancy(kw["occ_in"], nbr, 3, 2, 1)
    ref, ref_occ = fused_pillar_conv_packed(x, nbr, packed, **kw)
    assert torch.equal(occ, ref_occ)
    rows = active_rows(occ)
    got = fused_pillar_conv_packed(x, nbr, packed, z_stride=2, z_pad=1,
                                   occ_out=occ, relu=True, rows=rows)
    assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="active_rows"):
        fused_pillar_conv_packed(x, nbr, packed, z_stride=2, z_pad=1,
                                 occ_out=occ.clone(), relu=True, rows=rows)
    empty = torch.zeros_like(occ)
    out = fused_pillar_conv_packed(x, nbr, packed, z_stride=2, z_pad=1,
                                   occ_out=empty, relu=True)
    torch.cuda.synchronize()
    assert not out.any()


@pytest.mark.cuda
def test_cp_async_gather_wgmma_n16_matches_matmul():
    """The bf16 pillar kernel's A path alone (csrc/wgmma_selftest.cu, which
    3): rows of a gathered by cp.async through a row map, a zero-filled
    row (src-size 0) where the map is -1, into the 128-byte swizzle, fenced
    to the async proxy, then wgmma m64n16k16 against a TMA-loaded B, four
    16-deep slices; against torch.matmul in float32 (bf16 inputs: exact up
    to the summation order)."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn(64, 64, generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn(16, 64, generator=g, device=dev).to(torch.bfloat16)
    idx = torch.randperm(64, generator=g, device=dev).int()
    idx[::5] = -1
    got = gather_wgmma_check(a, b, idx)
    gathered = torch.where(idx[:, None] >= 0, a[idx.clamp(min=0).long()],
                           torch.zeros_like(a))
    torch.cuda.synchronize()
    _assert_rel(got, gathered.float() @ b.float().t(), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("heads,dh,nq,nk", [(8, 32, 900, 1000),
                                            (4, 8, 24, 256),
                                            (2, 16, 70, 63),
                                            (1, 4, 5, 3)])
def test_attention_kernel_matches_plain(dtype, tol, heads, dh, nq, nk):
    """Ragged query and key edges, NEG_INF keys in one batch row; q scaled
    so the softmax peaks (logit std 4)."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(2, n, heads * dh, generator=g, device=dev).mul(
        s).to(dtype) for n, s in ((nq, 4.0), (nk, 1.0), (nk, 1.0)))
    kb = torch.zeros(2, nk, device=dev)
    kb[1, nk // 2:] = NEG_INF
    _assert_close(flash_attention_packed(q, k, v, kb, heads),
                  flash_attention_packed_reference(q, k, v, kb, heads), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 1, 2])
def test_wgmma_primitives_match_matmul(which):
    """Each Hopper primitive the bf16 flash kernels build on, one 64-row
    product against torch.matmul in float32 (csrc/wgmma_selftest.cu): 0,
    wgmma m64n32k16 with both operands K-major in 64-byte-swizzled rows; 1,
    the same with B MN-major (the tnspB descriptor); 2, m64n64k16 on
    64-byte rows, then its accumulators repacked to bf16 as the A operand of
    the register-A form against an MN-major B. Inputs are bf16, so the
    products are exact up to the float32 summation order."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(which)
    a = torch.randn(64, 32, generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn(64 if which == 2 else 32, 32, generator=g,
                    device=dev).to(torch.bfloat16)
    c = torch.randn(64, 32, generator=g, device=dev).to(torch.bfloat16)
    if which < 2:
        got = wgmma_check(which, a, b)
        want = a.float() @ (b.float().t() if which == 0 else b.float())
    else:
        got, x = wgmma_check(2, a, b, c)
        _assert_rel(x, a.float() @ b.float().t(), 1e-5)
        want = x.to(torch.bfloat16).float() @ c.float()
    torch.cuda.synchronize()
    _assert_rel(got, want, 1e-5)


def _packed_tc_inputs(dev, b, nq, nk, heads, all_masked_row=True):
    """bf16 packed projections, q scaled so the softmax peaks (logit std
    4), a quarter of the keys of batch row 0 masked with NEG_INF, and
    every key of the last batch row masked (its rows then average V
    uniformly)."""
    g = torch.Generator(device=dev).manual_seed(nk)
    q, k, v = (torch.randn(b, n, heads * 32, generator=g, device=dev).mul(
        s).to(torch.bfloat16) for n, s in ((nq, 4.0), (nk, 1.0), (nk, 1.0)))
    masked = torch.rand(b, nk, generator=g, device=dev) < 0.25
    if all_masked_row and b > 1:
        masked[-1] = True
    return q, k, v, torch.where(masked, NEG_INF, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,heads,nq,nk", [(2, 8, 900, 36400),
                                           (2, 8, 900, 44400),
                                           (2, 8, 900, 1000),
                                           (1, 2, 193, 129), (2, 1, 5, 3)])
def test_attention_tc_kernel_matches_plain(b, heads, nq, nk):
    """Kernel 3's tensor-core route (bf16, Dh 32) at the fusion path's
    memories and small ragged sizes (one key tile, a query tile of one
    row, under a 16-key slice): within 2e-2 of max |plain|, the launch
    counted at its shape."""
    dev = cuda_device()
    q, k, v, kb = _packed_tc_inputs(dev, b, nq, nk, heads)
    before = dict(_build.launch_shapes)
    got = flash_attention_packed(q, k, v, kb, heads)
    shape = ("flash_attention_packed", (nq, nk, heads, 32))
    assert _build.launch_shapes[shape] == before.get(shape, 0) + 1
    want = flash_attention_packed_reference(q, k, v, kb, heads)
    _assert_rel(got, want, 2e-2)
    if b > 1:  # the fully masked row: the uniform average of V
        _assert_rel(got[-1], want[-1], 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("nk", [44400, 1000])
def test_attention_tc_kernel_is_deterministic(nk):
    """The split-KV partials are merged in a fixed order: two calls give
    the same bits."""
    dev = cuda_device()
    q, k, v, kb = _packed_tc_inputs(dev, 1, 900, nk, 8)
    first = flash_attention_packed(q, k, v, kb, 8)
    assert torch.equal(first, flash_attention_packed(q, k, v, kb, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("nk", [44400, 1001])
def test_train_backward_tc_kernel_at_full_width(rate, nk):
    """Kernel 8's tensor-core route at the train step's 1540 queries x 8
    heads x 32 in bf16, a quarter of the keys masked, on the plain
    forward's (out, m, l): dq, dk, dv and d(k_bias) within 2e-2 of max
    |plain| (the dropout-0.1 case agrees only if the keep bits are
    `dropout_keep`'s); dq and d(k_bias) bit-equal across two calls; without
    d(k_bias) the same dq, dk, dv."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(nk)
    b, h, nq = 1, 8, 1540
    q, k, v = (torch.randn(b, n, h * 32, generator=g, device=dev).mul(
        s).to(torch.bfloat16).view(b, n, h, 32).transpose(1, 2)
        for n, s in ((nq, 4.0), (nk, 1.0), (nk, 1.0)))
    kb = torch.where(torch.rand(b, nk, generator=g, device=dev) < 0.25,
                     NEG_INF, 0.0)
    out, m, l = flash_attention_kvmask_reference(q, k, v, kb, True, rate, 5)
    dout = torch.randn(b, h, nq, 32, generator=g, device=dev).to(
        torch.bfloat16)
    got = flash_attention_bwd(q, k, v, kb, out, m, l, dout, rate, 5)
    want = flash_attention_bwd_reference(q, k, v, kb, out, m, l, dout, rate,
                                         5)
    for a, r in zip(got, want):
        _assert_rel(a, r, 2e-2)
    again = flash_attention_bwd(q, k, v, kb, out, m, l, dout, rate, 5)
    assert torch.equal(got[0], again[0]) and torch.equal(got[3], again[3])
    no_kb = flash_attention_bwd(q, k, v, kb, out, m, l, dout, rate, 5, False)
    assert no_kb[3] is None
    for a, r in zip(no_kb[:3], got):
        assert torch.equal(a, r)


def _train_tc_inputs(dev, b, nq, nk, h=8):
    """bf16 (B, H, N, 32) views of packed (B, N, H*32) projections, q
    scaled so the softmax peaks (logit std 4), a quarter of the keys
    masked with NEG_INF and, with two batch rows, every key of the last
    (its rows then average V uniformly, m = NEG_INF, l = Nk)."""
    g = torch.Generator(device=dev).manual_seed(nq + nk)
    q, k, v = (torch.randn(b, n, h * 32, generator=g, device=dev).mul(
        s).to(torch.bfloat16).view(b, n, h, 32).transpose(1, 2)
        for n, s in ((nq, 4.0), (nk, 1.0), (nk, 1.0)))
    masked = torch.rand(b, nk, generator=g, device=dev) < 0.25
    if b > 1:
        masked[-1] = True
    return q, k, v, torch.where(masked, NEG_INF, 0.0)


TRAIN_TC_CASES = [(1, 1540, 44400, 0.0), (1, 1540, 44400, 0.1),
                  (2, 1001, 1001, 0.0), (2, 1001, 1001, 0.1),
                  (2, 1001, 129, 0.0), (2, 1001, 129, 0.1),
                  (2, 193, 129, 0.1), (2, 5, 3, 0.1)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,nq,nk,rate", TRAIN_TC_CASES)
def test_train_forward_tc_kernel_matches_plain(b, nq, nk, rate):
    """Kernel 7's tensor-core route (bf16, Dh 32) at the train step's 1540
    queries x 44400 keys and at ragged sizes (1001 = 5 x 192 + 41 queries,
    193: a block's warpgroups of one real row and of none, 5; 1001, 129
    keys and 3, under a 16-key slice), dropout 0 and 0.1, on strided views:
    out, m and l of each batch row within 2e-2 of that row's max |plain|
    (the fully masked last row's l exactly Nk), one launch counted a call,
    and two calls bit-equal."""
    dev = cuda_device()
    q, k, v, kb = _train_tc_inputs(dev, b, nq, nk)
    before = _build.launch_counts["flash_train_fwd"]
    got = flash_attention_kvmask(q, k, v, kb, True, rate, 9)
    assert _build.launch_counts["flash_train_fwd"] == before + 1
    want = flash_attention_kvmask_reference(q, k, v, kb, True, rate, 9)
    for row in range(b):
        for a, r in zip(got, want):
            _assert_rel(a[row], r[row], 2e-2)
    if b > 1:
        assert torch.equal(got[2][-1], want[2][-1])  # l = Nk exactly
    again = flash_attention_kvmask(q, k, v, kb, True, rate, 9)
    for a, r in zip(got, again):
        assert torch.equal(a, r)


@pytest.mark.cuda
@pytest.mark.parametrize("b,nq,nk", [(2, 1001, 1001), (1, 1540, 44400)])
def test_train_forward_then_backward_tc_matches_plain(b, nq, nk):
    """Kernel 7's (out, m, l) fed to kernel 8 at dropout 0.1: dq, dk, dv
    and d(k_bias) within 2e-2 of max |plain| of the plain forward and
    backward, the fully masked row included (its m must bring the
    backward's recomputed P back to 1 / Nk)."""
    dev = cuda_device()
    q, k, v, kb = _train_tc_inputs(dev, b, nq, nk)
    dout = torch.randn(q.shape, generator=torch.Generator(
        device=dev).manual_seed(3), device=dev).to(torch.bfloat16)
    out, m, l = flash_attention_kvmask(q, k, v, kb, True, 0.1, 6)
    got = flash_attention_bwd(q, k, v, kb, out, m, l, dout, 0.1, 6)
    ref = flash_attention_kvmask_reference(q, k, v, kb, True, 0.1, 6)
    want = flash_attention_bwd_reference(q, k, v, kb, *ref, dout, 0.1, 6)
    for a, r in zip(got, want):
        _assert_rel(a, r, 2e-2)
    if b > 1:
        _assert_rel(got[0][-1], want[0][-1], 2e-2)


@pytest.mark.cuda
def test_train_forward_tc_refuses_views_tma_cannot_take():
    """A bf16 Dh-32 view off a 16-byte boundary raises: the route never
    gives way to the CUDA-core kernel."""
    dev = cuda_device()
    q, k, v, kb = _train_tc_inputs(dev, 1, 64, 128, h=2)
    flat = torch.zeros(k.numel() + 1, dtype=torch.bfloat16, device=dev)
    shifted = flat[1:].view(1, 128, 2, 32).transpose(1, 2)
    before = _build.launch_counts["flash_train_fwd"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_kvmask(q, shifted, v, kb, True, 0.1, 1)
    assert _build.launch_counts["flash_train_fwd"] == before


# kernel 4/5 shapes on the card: stage 5 of one view (under one wave, W not
# a multiple of the 16-pixel tile row; Cin 224 and 1024), stage 4 of three
# views (64-pixel tiles), the head (180x180, 128-pixel tiles, 2.1 waves), a
# ragged 45x45 head, and narrow widths (Cin 24 < the 64-channel chunk, Cout
# 40 < the 64-wide block)
CONV_SHAPES = [(1, 20, 50, 224, 224), (1, 20, 50, 1024, 224),
               (3, 40, 100, 768, 192), (1, 180, 180, 512, 256),
               (1, 45, 45, 512, 256), (2, 7, 13, 24, 40)]


def _conv_inputs(dev, dtype, shape, with_resid):
    b, h, w, cin, cout = shape
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(b, h, w, cin, generator=g, device=dev).to(dtype)
    wt = torch.randn(cout, cin, 3, 3, generator=g, device=dev) \
        / (9 * cin) ** 0.5
    s = 1 + 0.1 * torch.randn(cout, generator=g, device=dev)
    bb = 0.1 * torch.randn(cout, generator=g, device=dev)
    kw = {}
    if with_resid:
        kw["residual"] = torch.randn(b, h, w, cout, generator=g,
                                     device=dev).to(dtype)
    return (x, wt, s, bb), kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_kernel_matches_plain(dtype, tol, shape):
    """Kernel 4: bf16 on the tensor cores, float32 on the CUDA cores; one
    launch counted under its name."""
    dev = cuda_device()
    args, _ = _conv_inputs(dev, dtype, shape, False)
    before = dict(_build.launch_counts)
    got = conv3x3_bn_relu(*args)
    assert _build.launch_counts["conv3x3_bn_relu"] == \
        before["conv3x3_bn_relu"] + 1
    assert _build.launch_counts["conv3x3_bn_relu_resid"] == \
        before["conv3x3_bn_relu_resid"]
    _assert_close(got, conv3x3_bn_relu_reference(*args), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shape", [(3, 20, 30, 160, 160)] + CONV_SHAPES)
def test_conv_residual_kernel_matches_plain(dtype, tol, shape):
    """Kernel 5: ragged pixel tiles, Cout not a multiple of 128 (160, 224,
    192, 40)."""
    dev = cuda_device()
    args, kw = _conv_inputs(dev, dtype, shape, True)
    before = dict(_build.launch_counts)
    _assert_close(conv3x3_bn_relu(*args, **kw),
                  conv3x3_bn_relu_reference(*args, **kw), tol)
    assert _build.launch_counts["conv3x3_bn_relu_resid"] == \
        before["conv3x3_bn_relu_resid"] + 1
    assert _build.launch_counts["conv3x3_bn_relu"] == \
        before["conv3x3_bn_relu"]


@pytest.mark.cuda
def test_bf16_conv_keeps_its_weight_map_and_checks_the_plan():
    """The packed weight's TMA map is encoded at the first bf16 launch and
    kept; each launch records its shape; the C entry point refuses a plan
    whose tiles do not cover the image exactly."""
    dev = cuda_device()
    shape = (1, 20, 50, 224, 224)
    (x, wt, s, bb), _ = _conv_inputs(dev, torch.bfloat16, shape, False)
    packed = pack_conv3x3_weight(wt, s, bb, torch.bfloat16)
    assert packed.tc_map is None
    _build.reset_counts()
    y = conv3x3_bn_relu_packed(x, packed)
    first = packed.tc_map
    assert first is not None
    assert torch.equal(conv3x3_bn_relu_packed(x, packed), y)
    assert packed.tc_map is first
    assert _build.launch_shapes == {("conv3x3_bn_relu", shape): 2}
    plan = conv3x3_plan(*shape, sm_count(x.device))
    out = torch.empty_like(y)
    for tiles_w, tiles_h in ((plan.tiles_w + 1, plan.tiles_h),
                             (plan.tiles_w, plan.tiles_h - 1)):
        rc = _build.lib().cmt_conv3x3_bn_relu_tc(
            x.data_ptr(), first, packed.scale.data_ptr(),
            packed.bias.data_ptr(), None, out.data_ptr(), *shape[:4],
            plan.cin_pad, shape[4], plan.bn, plan.wg, tiles_w, tiles_h, 1,
            _build.stream_ptr(x.device))
        assert rc != 0


@pytest.mark.cuda
def test_bf16_conv_refuses_cin_12():
    """TMA needs 16-byte strides: bf16 with Cin 12 raises before any launch
    (float32 takes the CUDA-core kernel, which has no such limit)."""
    dev = cuda_device()
    args, _ = _conv_inputs(dev, torch.bfloat16, (1, 8, 8, 12, 16), False)
    before = dict(_build.launch_counts)
    with pytest.raises(ValueError, match="multiples of 8"):
        conv3x3_bn_relu(*args)
    assert _build.launch_counts == before
    x, *rest = args
    _assert_close(conv3x3_bn_relu(x.float(), *rest),
                  conv3x3_bn_relu_reference(x.float(), *rest), 1e-4)


def _agg_inputs(dev, dtype, v, h, w, chans, cout, bias_shift=0.0):
    g = torch.Generator(device=dev).manual_seed(0)
    parts = [torch.randn(v, h, w, c, generator=g, device=dev).to(dtype)
             for c in chans]
    wt = torch.randn(sum(chans), cout, generator=g, device=dev) \
        / sum(chans) ** 0.5
    s = 1 + 0.1 * torch.randn(cout, generator=g, device=dev)
    bb = 0.1 * torch.randn(cout, generator=g, device=dev) + bias_shift
    return parts, wt, s, bb


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("v,h,w,chans,cout", [
    (3, 20, 50, (256, 80, 80, 80, 80, 80), 200),
    (2, 7, 13, (24, 16), 40),
    (1, 20, 50, (1024,) + (224,) * 5, 1024),
    (3, 80, 200, (256,) + (160,) * 5, 512),
    (2, 9, 23, (160, 224, 8), 264)])
def test_osa_aggregate_kernel_matches_plain(dtype, tol, v, h, w, chans,
                                            cout):
    """Kernel 6: ragged pixel tiles inside each view (H*W % 128 != 0), Cout
    not a multiple of 128, 6, 3 and 2 parts; parts of 160 and 224 channels
    (half a 64-channel chunk at their end) and of 8; the stage-5 V1 shape
    (its plan's small tiles) with Cout 1024 (four or more column tiles);
    agg and the float32 gap, each against max |plain|; one launch a call,
    counted at its shape."""
    dev = cuda_device()
    parts, wt, s, bb = _agg_inputs(dev, dtype, v, h, w, chans, cout)
    before = _build.launch_counts["osa_aggregate"]
    _build.launch_shapes.clear()
    agg, gap = osa_aggregate(parts, wt, s, bb)
    ref_agg, ref_gap = osa_aggregate_reference(parts, wt, s, bb)
    assert _build.launch_counts["osa_aggregate"] == before + 1
    assert _build.launch_shapes == {
        ("osa_aggregate", (v, h, w) + chans + (cout,)): 1}
    assert agg.dtype == dtype and gap.dtype == torch.float32
    _assert_rel(agg, ref_agg, tol)
    _assert_rel(gap, ref_gap, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("v,h,w", [(3, 9, 15), (3, 20, 50), (2, 33, 61)])
def test_osa_aggregate_ragged_views_with_positive_bias(dtype, tol, v, h, w):
    """A bias of about +1 makes a zero-filled pixel row past a view's end
    relu(bias) > 0: were it stored, it would overwrite the next view's first
    pixels, and were it summed, the gap would grow. H*W is no multiple of
    64 or 128, so every view ends inside a tile; the views differ, so a
    row of the next view read into a tile would show too."""
    dev = cuda_device()
    chans, cout = (64, 160, 224), 256
    parts, wt, s, bb = _agg_inputs(dev, dtype, v, h, w, chans, cout, 1.0)
    assert bool((bb > 0).all())
    parts = [p * torch.arange(1, v + 1, device=dev).view(v, 1, 1, 1).to(
        dtype) for p in parts]
    agg, gap = osa_aggregate(parts, wt, s, bb)
    ref_agg, ref_gap = osa_aggregate_reference(parts, wt, s, bb)
    _assert_rel(agg, ref_agg, tol)
    for i in range(v):
        _assert_rel(gap[i], ref_gap[i], tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 160, 400, (128,) * 6, 256),
                                   (1, 20, 50, (1024,) + (224,) * 5, 1024)])
def test_osa_aggregate_gap_is_deterministic(shape):
    """Two calls give bit-equal agg and gap: the partial rows are summed in
    a fixed order, with no atomics."""
    dev = cuda_device()
    v, h, w, chans, cout = shape
    parts, wt, s, bb = _agg_inputs(dev, torch.bfloat16, v, h, w, chans, cout)
    packed = pack_osa_weight(wt, s, bb, chans, torch.bfloat16)
    a0, g0 = osa_aggregate_packed(parts, packed)
    a1, g1 = osa_aggregate_packed(parts, packed)
    assert torch.equal(a0, a1) and torch.equal(g0, g1)


@pytest.mark.cuda
@pytest.mark.parametrize("v,h,w,chans,cout", [
    (3, 20, 50, (1024,) + (224,) * 5, 1024), (2, 9, 23, (160, 224, 8), 264)])
def test_every_aggregate_plan_gives_the_same_result(v, h, w, chans, cout):
    """Each tile the bf16 kernel takes (256, 192, 128 or 64 columns)
    agrees with the plain version, and the
    weight's maps of each column width are kept apart."""
    dev = cuda_device()
    parts, wt, s, bb = _agg_inputs(dev, torch.bfloat16, v, h, w, chans,
                                   cout, 0.5)
    ref_agg, ref_gap = osa_aggregate_reference(parts, wt, s, bb)
    packed = pack_osa_weight(wt, s, bb, chans, torch.bfloat16)
    plans = osa_agg_plans(v, h * w, chans, cout)
    assert len(plans) == 4
    for plan in plans:
        agg, gap = osa_aggregate_packed(parts, packed, plan)
        _assert_rel(agg, ref_agg, 2e-2)
        _assert_rel(gap, ref_gap, 2e-2)
    assert set(packed.tc_maps) == {64, 128, 192, 256}


@pytest.mark.cuda
def test_bf16_aggregate_keeps_its_weight_map_and_checks_the_plan():
    """The packed weight's TMA map is encoded at the first bf16 launch and
    kept; the C entry point refuses a plan whose tiles do not cover the
    views or Cout exactly, or a kpad that the parts do not fill."""
    dev = cuda_device()
    v, h, w, chans, cout = 3, 40, 100, (768,) + (192,) * 5, 768
    parts, wt, s, bb = _agg_inputs(dev, torch.bfloat16, v, h, w, chans, cout)
    packed = pack_osa_weight(wt, s, bb, chans, torch.bfloat16)
    assert not packed.tc_maps
    agg, gap = osa_aggregate_packed(parts, packed)
    plan = osa_agg_plan(v, h * w, chans, cout, sm_count(dev))
    first = packed.tc_maps[plan.bn]
    a1, g1 = osa_aggregate_packed(parts, packed)
    assert packed.tc_maps == {plan.bn: first}
    assert torch.equal(a1, agg) and torch.equal(g1, gap)
    out, gp = torch.empty_like(agg), torch.empty_like(gap)
    partial = torch.empty(v, plan.tiles + 1, cout, device=dev)
    for tiles, col_tiles, kpad in ((plan.tiles + 1, plan.col_tiles,
                                    plan.kpad),
                                   (plan.tiles, plan.col_tiles - 1,
                                    plan.kpad),
                                   (plan.tiles, plan.col_tiles,
                                    plan.kpad - 64)):
        rc = _build.lib().cmt_osa_aggregate_tc(
            len(parts), *[p.data_ptr() for p in parts], *chans, first,
            packed.bias.data_ptr(), out.data_ptr(), partial.data_ptr(),
            gp.data_ptr(), v, h * w, cout, kpad, plan.bn, tiles, col_tiles,
            _build.stream_ptr(dev))
        assert rc != 0


@pytest.mark.cuda
def test_bf16_aggregate_refuses_channels_tma_cannot_stride():
    """A part of 12 channels (no 16-byte stride) raises before any launch
    in bf16; float32 takes the CUDA-core kernel, which has no such
    limit."""
    dev = cuda_device()
    parts, wt, s, bb = _agg_inputs(dev, torch.bfloat16, 2, 5, 7, (16, 12),
                                   24)
    before = dict(_build.launch_counts)
    with pytest.raises(ValueError, match="multiples of 8"):
        osa_aggregate(parts, wt, s, bb)
    assert _build.launch_counts == before
    parts = [p.float() for p in parts]
    agg, gap = osa_aggregate(parts, wt, s, bb)
    ref_agg, ref_gap = osa_aggregate_reference(parts, wt, s, bb)
    _assert_rel(agg, ref_agg, 1e-4)
    _assert_rel(gap, ref_gap, 1e-4)


@pytest.mark.cuda
def test_osa_module_on_the_card_holds_its_aggregate_pack():
    """An eval OSA block on the card (float32): the aggregate launches on
    the pack its module holds, and the block agrees with itself on the
    CPU."""
    dev = cuda_device()
    mod = OSAModule(64, 160, 256, 5, "OSA3_1", identity=False).eval()
    g = torch.Generator().manual_seed(0)
    mod.load_state_dict({k: torch.rand(t.shape, generator=g) * 0.2 + 0.9
                         for k, t in mod.state_dict().items()})
    x = torch.randn(2, 12, 20, 64, generator=g)
    with torch.inference_mode():
        ref = mod(x)
        mod.to(dev)
        before = _build.launch_counts["osa_aggregate"]
        y0 = mod(x.to(dev))
        first = mod.agg_pack.packed
        y1 = mod(x.to(dev))
    assert mod.agg_pack.packed is first
    assert first.weight.dtype == torch.float32
    assert _build.launch_counts["osa_aggregate"] == before + 2
    assert torch.equal(y0, y1)
    _assert_rel(y0.cpu(), ref, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,h,dh,nq,nk", [(1, 8, 32, 300, 1000),
                                          (2, 2, 32, 70, 63),
                                          (1, 1, 8, 5, 130),
                                          (1, 3, 8, 64, 64)])
def test_train_attention_kernels_match_plain(dtype, tol, rate, b, h, dh, nq,
                                             nk):
    """Kernels 7 and 8 on (B, H, N, Dh) views of packed (B, N, H*Dh)
    projections, ragged query and key edges, NEG_INF keys in the last
    batch row, q scaled so the softmax peaks; the dropout mask is the plain
    version's exactly, so with dropout the outputs still agree to the
    tolerance. The backward is given the kernel forward's (out, m, l);
    without d(k_bias) it writes the same dq, dk, dv."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(b, n, h * dh, generator=g, device=dev).mul(
        s).to(dtype).view(b, n, h, dh).transpose(1, 2)
        for n, s in ((nq, 4.0), (nk, 1.0), (nk, 1.0)))
    kb = torch.zeros(b, nk, device=dev)
    kb[-1, nk // 2:] = NEG_INF
    before = dict(_build.launch_counts)
    out, m, l = flash_attention_kvmask(q, k, v, kb, True, rate, 11)
    ref = flash_attention_kvmask_reference(q, k, v, kb, True, rate, 11)
    for got, want in zip((out, m, l), ref):
        _assert_rel(got, want, tol)
    dout = torch.randn(b, h, nq, dh, generator=g, device=dev).to(dtype)
    got = flash_attention_bwd(q, k, v, kb, out, m, l, dout, rate, 11)
    want = flash_attention_bwd_reference(q, k, v, kb, out, m, l, dout, rate,
                                         11)
    for a, r in zip(got, want):
        _assert_rel(a, r, tol)
    no_kb = flash_attention_bwd(q, k, v, kb, out, m, l, dout, rate, 11,
                                False)
    assert no_kb[3] is None
    for a, r in zip(no_kb[:3], got):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    assert _build.launch_counts["flash_train_fwd"] == \
        before["flash_train_fwd"] + 1
    for name in ("flash_train_bwd_dq", "flash_train_bwd_dkv"):
        assert _build.launch_counts[name] == before[name] + 2


def _on_card_matches_cpu(model_fn, batch, kernels):
    dev = cuda_device()
    cpu = model_fn()
    random_init_(cpu, torch.Generator().manual_seed(0))
    gpu = model_fn()
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(dev)
    _build.reset_counts()
    with torch.inference_mode():
        ref, _ = cpu({k: torch.from_numpy(v) for k, v in batch.items()})
        got, _ = gpu({k: torch.from_numpy(v).to(dev)
                      for k, v in batch.items()})
    assert {k for k, n in _build.launch_counts.items() if n} == set(kernels)
    for o, r in zip(got, ref):
        for key in r:
            torch.testing.assert_close(o[key].cpu(), r[key], rtol=1e-3,
                                       atol=1e-3)


def _sorted_sites(rng, shape, n, cap):
    """(coords (cap, D) int32, mask (cap,)): n distinct random cells of
    `shape` in ascending linear order, every corner cell among them, then
    padding rows (coords -1)."""
    cells = int(np.prod(shape))
    corners = [np.ravel_multi_index([(s - 1) * b for s, b in zip(shape, bits)],
                                    shape)
               for bits in itertools.product((0, 1), repeat=len(shape))]
    lin = np.unique(np.concatenate([corners, rng.choice(
        cells, max(n - len(corners), 0), replace=False)]))
    coords = np.full((cap, len(shape)), -1, np.int32)
    coords[:len(lin)] = np.stack(np.unravel_index(lin, shape), -1)
    return torch.from_numpy(coords), torch.arange(cap) < len(lin)


# kernel 9's card cases: (grid shape, sites, cap, kernel, stride, pad, what
# the output sites are); "subm": the grid's own sites, "down": the
# downsample grid of a strided conv, "shuffled": the sites in random order
# (brackets as wide as the key array), "no keys": an input grid of padding
# rows only, "tail": 900 padding rows after 100 sites (warps of padding
# rows only), "empty": no output site
NMAP_CASES = {
    "pillar 3x3": ((180, 200), 12000, 12800, (3, 3), 1, 1, "subm"),
    "pillar 5x3": ((180, 200), 12000, 12800, (5, 3), 1, (2, 1), "subm"),
    "pillar down": ((180, 200), 12000, 12800, (3, 3), 2, 1, "down"),
    "voxel 3x3x3": ((41, 200, 200), 30000, 32768, (3, 3, 3), 1, 1, "subm"),
    "voxel 3x1x3": ((41, 200, 200), 30000, 32768, (3, 1, 3), 1, (1, 0, 1),
                    "subm"),
    "voxel down": ((41, 200, 200), 30000, 32768, (3, 3, 3), 2, (0, 1, 1),
                   "down"),
    "conv_out": ((11, 60, 60), 9000, 9216, (3, 1, 1), (2, 1, 1), 0,
                 "down"),
    "full width": ((41, 1440, 1440), 65536, 65536, (3, 3, 3), 1, 1, "subm"),
    "shuffled": ((41, 200, 200), 30000, 32768, (3, 3, 3), 1, 1, "shuffled"),
    "no keys": ((41, 200, 200), 0, 4096, (3, 3, 3), 2, 1, "no keys"),
    "tail": ((9, 30, 30), 100, 1000, (3, 3, 3), 1, 1, "subm"),
    "empty": ((9, 30, 30), 100, 128, (3, 3, 3), 2, 1, "empty"),
}


def _nmap_case(name):
    """(keys, coords, mask, shape, kernel, stride, pad) of one of
    `NMAP_CASES`, on the CPU."""
    shape, n, cap, ks, st, pad, kind = NMAP_CASES[name]
    rng = np.random.default_rng(len(name))
    coords, mask = _sorted_sites(rng, shape, max(n, 1), cap)
    mask &= n > 0
    coords = torch.where(mask[:, None], coords, -1).int()
    dims = len(shape)
    grid = (pu.PillarGrid(coords, mask, shape, 1) if dims == 2
            else su.SparseGrid(coords, mask, shape))
    keys = grid.linear_ids
    out_c, out_m = coords, mask
    if kind == "down" and dims == 2:
        out = pu.pillar_downsample_grid(grid, cap, st, ks[0], pad)
        out_c, out_m = out.coords, out.mask
    elif kind in ("down", "no keys", "empty"):
        ks3, st3, pad3 = (tuple(v) if not isinstance(v, int) else (v,) * 3
                          for v in (ks, st, pad))
        src = su.SparseGrid(*_sorted_sites(rng, shape, 3000, 3072), shape) \
            if kind == "no keys" else grid
        out = su.downsample_output_grid(src, ks3, st3, pad3,
                                        0 if kind == "empty" else cap)
        out_c, out_m = out.coords, out.mask
    elif kind == "shuffled":
        perm = torch.from_numpy(rng.permutation(cap))
        out_c, out_m = coords[perm].contiguous(), mask[perm].contiguous()
    return keys, out_c, out_m, shape, ks, st, pad


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(NMAP_CASES))
def test_neighbor_map_kernel_matches_plain(name):
    """Kernel 9 against its plain version, bit-equal: 2-D and 3-D tap
    tables, strided maps, conv_out's, the full-width key count, sites in
    random order, no keys, warps of padding rows, no output site; one
    launch a map (none for no output site)."""
    dev = cuda_device()
    keys, coords, mask, *geom = _nmap_case(name)
    keys, coords, mask = keys.to(dev), coords.to(dev), mask.to(dev)
    before = _build.launch_counts["neighbor_map"]
    got = neighbor_map(keys, coords, mask, *geom)
    torch.cuda.synchronize()
    assert _build.launch_counts["neighbor_map"] == before + (
        coords.shape[0] > 0)
    ref = neighbor_map_reference(keys, coords, mask, *geom)
    assert got.dtype == ref.dtype == torch.int32 and torch.equal(got, ref)
    if name not in ("no keys", "empty"):
        assert (got < keys.shape[0]).any()


@pytest.mark.cuda
def test_map_builders_run_without_a_host_sync():
    """The pillar encoder's map builders over three levels and the gather
    encoder's `maps` make no host synchronisation, and each map is one
    kernel-9 launch."""
    dev = cuda_device()
    rng = np.random.default_rng(3)
    pc, pm = _sorted_sites(rng, (120, 120), 3000, 3072)
    grid = pu.PillarGrid(pc.to(dev), pm.to(dev), (120, 120), 9)
    vc, vm = (t.to(dev) for t in _sorted_sites(rng, (41, 120, 120), 6000,
                                               6144))
    enc = SparseEncoder(sparse_shape=(41, 120, 120),
                        stage_caps=(8192, 4096, 2048, 2048))
    torch.cuda.synchronize()
    before = _build.launch_counts["neighbor_map"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        keys = grid.linear_ids
        pu.pillar_neighbor_map(grid, keys=keys)
        for cap in (4096, 2048):
            out = pu.pillar_downsample_grid(grid, cap)
            pu.pillar_conv_neighbor_map(grid, out, keys=keys)
            grid, keys = out, out.linear_ids
            pu.pillar_neighbor_map(grid, keys=keys)
        maps = enc.maps(vc, vm)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert _build.launch_counts["neighbor_map"] == before + 5 + 8
    assert len(maps.subm) == 4 and len(maps.down) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", [(torch.bfloat16, (40960, 768)),
                                         (torch.float32, (1000, 37)),
                                         (torch.float32, (999, 37)),
                                         (torch.uint8, (513, 7)),
                                         (torch.int64, (3, 2))])
def test_rows_copy_kernel_matches_clone(dtype, shape):
    """Kernel 10 against `clone()`: bit-equal, 16-, 4- and 1-byte words
    (float32 (1000, 37): 16-byte words across its 148-byte rows; (999, 37):
    4-byte words)."""
    dev = cuda_device()
    x = torch.randint(0, 100, shape, device=dev).to(dtype)
    before = _build.launch_counts["rows_copy"]
    y = pin_rows(x)
    torch.cuda.synchronize()
    assert _build.launch_counts["rows_copy"] == before + 1
    assert y.data_ptr() != x.data_ptr()
    assert torch.equal(y, pin_rows_reference(x))


@pytest.mark.cuda
def test_slice_on_card_matches_cpu():
    """The small LiDAR detector with seeded weights: the card's forward
    (kernels 1 to 4, float32) against the CPU's (plain versions), rtol =
    atol = 1e-3."""
    _on_card_matches_cpu(slice_model, small_coop_batch(),
                         main_path.PATH_KERNELS[main_path.PRESET])


@pytest.mark.cuda
def test_fusion_slice_on_card_matches_cpu():
    """The small fusion detector: kernels 1 to 4 and 6 on the card against
    the plain versions on the CPU, float32, rtol = atol = 1e-3."""
    _on_card_matches_cpu(fusion_slice_model, small_fusion_batch(),
                         main_path.PATH_KERNELS[main_path.FUSION_PRESET])


@pytest.mark.cuda
def test_gather_slice_on_card_matches_cpu():
    """The small LiDAR detector with the gather encoder: kernels 3, 4 and 9
    on the card against the plain versions on the CPU, float32."""
    _on_card_matches_cpu(gather_slice_model, small_coop_batch(),
                         main_path.PATH_KERNELS[main_path.GATHER_PATH])


@pytest.mark.cuda
def test_resnet50_bf16_at_six_320x800_views_matches_its_plain_path():
    """The port's eval ResNet-50 at `cmt_fusion_r50_nuscenes`' shapes (six
    320x800 views) in bf16, BN folded into fused cuDNN calls (no kernel-4
    launch: cuDNN ran each of its 3x3 shapes faster), against the same
    model's plain path (train mode: unfolded `F.conv2d`, frozen BN) in
    float32 with TF32 off, on seeded weights: layer3 and layer4 within
    RESNET_BF16_TOL of the plain map's largest magnitude (bf16 rounding of
    every conv's operands and output through 53 convs and 16 residual
    sums)."""
    dev = cuda_device()
    model = ResNet(50)
    random_init_(model, torch.Generator().manual_seed(0))
    model.to(dev).eval()
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(6, 320, 800, 3, generator=gen).to(dev)
    _build.reset_counts()
    with torch.inference_mode():
        got = model(x.bfloat16())
        torch.cuda.synchronize()
        launches = _build.launch_counts["conv3x3_bn_relu"]
        model.train()
        want = model(x)
    assert launches == 0
    assert got["layer3"].shape == (6, 20, 50, 1024)
    assert got["layer4"].shape == (6, 10, 25, 2048)
    for k in ("layer3", "layer4"):
        _assert_rel(got[k], want[k], RESNET_BF16_TOL)
