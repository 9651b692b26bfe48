#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (cmtcoop_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):
  1. the device: its name and `nvidia-smi` name / power limit;
  2. the kernel build (nvcc, sm_90a) and its seconds;
  3. each hand-written kernel against its plain PyTorch version on the card,
     at the main path's shapes (neighbour maps and occupancy from the
     benchmark cloud), in bfloat16 and float32, with error and time;
  4. the main path: `build_detector` on `cmt_lidar_coop_tumtraf` at full
     width in bfloat16 with seeded random weights, on the benchmark batch
     (two 65536-point ray-cast clouds, seed 0): zero pillar and voxel cap
     drops at every level, warm-up plus 3 timed frames of forward and
     top-300 decode, finite BEV features and decoder outputs, every kernel's
     launch count above zero;
  5. slice parity: the small detector of the CPU parity tests
     (cmtcoop_tpu_torch/configs/presets.py `SMALL_COOP_*`), the GPU forward
     (kernels, float32) against the CPU forward (plain versions) on the
     same weights and inputs.

Before the last line come a JSON object with one entry per kernel and the
card's name and power limit from `nvidia-smi`; the last line is
`{"ok": true, "device": {...}}`. Without a CUDA device, or run
outside a checkout, it exits non-zero and prints no result.
"""
import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
SEED = 0
N_FRAMES = 3
# max |kernel - plain| / max |plain| allowed: float32 differs only by
# summation order; bfloat16 rounds the outputs (2^-8 relative) and the
# plain versions round one more intermediate, so a few output ulps
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SLICE_TOL = 1e-3  # float32 GPU vs CPU over the whole small detector

SOURCES = {
    "pillar_conv_kb9": ("cmtcoop_tpu_torch/csrc/pillar_conv.cu",
                        "cmtcoop_tpu/ops/pillar_fused.py:328"),
    "pillar_conv_kb1": ("cmtcoop_tpu_torch/csrc/pillar_conv.cu",
                        "cmtcoop_tpu/ops/pillar_fused.py:198"),
    "flash_attention_packed": ("cmtcoop_tpu_torch/csrc/flash_attention.cu",
                               "cmtcoop_tpu/ops/attention.py:214"),
    "conv3x3_bn_relu": ("cmtcoop_tpu_torch/csrc/conv3x3.cu",
                        "cmtcoop_tpu/ops/conv_cf.py:89"),
}


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, warmup=2, iters=5):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, shape_note, kernel, plain, make_inputs, results):
    """Kernel vs plain version on the same inputs, in bfloat16 and float32;
    `make_inputs(dtype)` gives (args, kwargs). Records the bf16 numbers."""
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        args, kw = make_inputs(dtype)
        got = kernel(*args, **kw)
        ref = plain(*args, **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for g, r in zip(got[1:], ref[1:]):  # exact side outputs (occupancy)
            if not torch.equal(g, r):
                raise AssertionError(f"{name} {shape_note} {dname}: "
                                     "occupancy differs from the plain version")
        g, r = got[0].float(), ref[0].float()
        if g.shape != r.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name} {shape_note} {dname}: shape "
                                 f"{tuple(g.shape)} vs {tuple(r.shape)} or "
                                 "non-finite output")
        err = float((g - r).abs().max())
        peak = float(r.abs().max())
        ok = err <= TOL[dname] * peak
        k_ms = cuda_ms(lambda: kernel(*args, **kw))
        p_ms = cuda_ms(lambda: plain(*args, **kw))
        log(f"kernel {name} [{shape_note}] {dname}: max_abs_err={err:.3e} "
            f"max_rel_err={err / max(peak, 1e-30):.3e} (max|plain|="
            f"{peak:.3e}, tol {TOL[dname]:g} of max|plain|) "
            f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {shape_note} {dname} disagrees")
        if dtype == torch.bfloat16:
            rec = results.setdefault(name, dict(max_abs_err=0.0))
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec.setdefault("ms", k_ms)
            rec.setdefault("plain_ms", p_ms)


def levels_of(batch, agent, ext):
    """Pillars and every level's grid, occupancy and maps for one cloud."""
    from cmtcoop_tpu_torch.main_path import PILLAR_CAPS
    from cmtcoop_tpu_torch.ops import pillars as pu
    pc, pm, occ, feats, stats = ext.pillarize(
        batch[agent + "points"][0], batch[agent + "points_mask"][0],
        return_stats=True)
    enc = ext.pts_middle_encoder
    d, h, w = enc.sparse_shape
    grid = pu.PillarGrid(pc, pm, (h, w), d)
    levels = [dict(grid=grid, occ=occ, nbr=pu.pillar_neighbor_map(grid))]
    counts = []
    for i, cap in enumerate(PILLAR_CAPS[1:]):
        out, n = pu.pillar_downsample_grid(grid, cap, return_n=True)
        nbr_dn = pu.pillar_conv_neighbor_map(grid, out)
        zp = (1, 1, 0)[i]
        occ = pu.occ_downsample(occ, nbr_dn, 3, 2, zp)
        levels[-1]["nbr_dn"], levels[-1]["zpad"] = nbr_dn, zp
        grid = out
        levels.append(dict(grid=grid, occ=occ,
                           nbr=pu.pillar_neighbor_map(grid)))
        counts.append(int(n))
    return stats, counts, levels


def kernel_phases(lv, results, dev):
    from cmtcoop_tpu_torch.ops import pillars as pu
    from cmtcoop_tpu_torch.ops.attention import (
        NEG_INF, flash_attention_packed, flash_attention_packed_reference)
    from cmtcoop_tpu_torch.ops.conv_cf import (conv3x3_bn_relu,
                                               conv3x3_bn_relu_reference)
    from cmtcoop_tpu_torch.ops.pillar_fused import (
        fused_pillar_conv, fused_pillar_conv_reference)

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def pillar_case(name, note, level, cin, cout, nbr, kw, with_resid):
        p_in, z_in = level["occ"].shape
        feats = randn(p_in, z_in, cin) * level["occ"][..., None]
        taps = 3 * nbr.shape[1]
        wts = randn(taps, cin, cout, scale=(taps * cin) ** -0.5)
        scale, bias = 1.0 + 0.1 * randn(cout), 0.1 * randn(cout)
        resid = (randn(p_in, z_in, cout) * level["occ"][..., None]
                 if with_resid else None)

        def inputs(dtype):
            a = dict(kw, scale=scale, bias=bias, relu=True)
            if resid is not None:
                a["residual"] = resid.to(dtype)
            return (feats.to(dtype), nbr, wts), a

        compare(name, note, fused_pillar_conv,
                fused_pillar_conv_reference, inputs, results)

    l0, l1, l3 = lv[0], lv[1], lv[3]
    pillar_case("pillar_conv_kb9", "stage-0 subm P38400 Z41 16->16", l0, 16,
                16, l0["nbr"], dict(kz=3, z_stride=1, z_pad=1,
                                    occ_out=l0["occ"]), True)
    pillar_case("pillar_conv_kb9", "stage-1 down fold_occ P40960->24064 "
                "Z21->11 32->64", l1, 32, 64, l1["nbr_dn"],
                dict(kz=3, z_stride=2, z_pad=l1["zpad"], occ_in=l1["occ"],
                     fold_occ=True), False)
    ident = pu.identity_map(l3["grid"])
    pillar_case("pillar_conv_kb1", "conv_out P11264 Z5->2 128->128", l3, 128,
                128, ident, dict(kz=3, z_stride=2, z_pad=0,
                                 occ_out=pu.occ_downsample(l3["occ"], ident,
                                                           3, 2, 0)), False)

    # q scaled so the softmax over 32400 keys peaks (logit std 4), a
    # quarter of the keys masked with NEG_INF as padded keys are
    q, k, v = randn(1, 900, 256, scale=4.0), randn(1, 32400, 256), randn(
        1, 32400, 256)
    masked = torch.rand(1, 32400, generator=gen, device=dev) < 0.25
    kbias = torch.where(masked, NEG_INF, 0.0)
    compare("flash_attention_packed", "q900 k32400 8x32, 1/4 keys masked",
            flash_attention_packed, flash_attention_packed_reference,
            lambda dt: ((q.to(dt), k.to(dt), v.to(dt), kbias, 8), {}),
            results)

    x = randn(1, 180, 180, 512)
    w = randn(256, 512, 3, 3, scale=(9 * 512) ** -0.5)
    s, b = 1.0 + 0.1 * randn(256), 0.1 * randn(256)
    compare("conv3x3_bn_relu", "180x180 512->256", conv3x3_bn_relu,
            conv3x3_bn_relu_reference,
            lambda dt: ((x.to(dt), w, s, b), {}), results)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "smoke test needs an NVIDIA GPU")
    if not (REPO / "cmtcoop_tpu_torch" / "csrc").is_dir():
        sys.exit("chip_smoke: run from the root of a checkout of the "
                 "repository (cmtcoop_tpu_torch/ not found)")
    sys.path.insert(0, str(REPO))
    from cmtcoop_tpu_torch import _build, main_path
    from cmtcoop_tpu_torch.configs.presets import (
        SMALL_COOP_EXTRACTOR, SMALL_COOP_HEAD, SMALL_COOP_PRESET, tiny_preset)
    from cmtcoop_tpu_torch.data.synthetic import small_coop_batch
    from cmtcoop_tpu_torch.main_path import PILLAR_CAPS
    from cmtcoop_tpu_torch.models.build import build_detector, random_init_

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {kind} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")

    # 2. build
    t0 = time.time()
    lib_path = _build.build()
    _build.lib()
    log(f"build: {time.time() - t0:.1f} s -> {lib_path.name}")

    # full-width model and the benchmark batch (shapes for phase 3 too)
    model, batch = main_path.build_main_path(dev)

    # cap telemetry (bench.py's): zero drops at every level
    levels = {}
    with torch.inference_mode():
        for agent in ("vehicle_", "infrastructure_"):
            ext = getattr(model, agent + "model")
            stats, counts, lv = levels_of(batch, agent, ext)
            levels[agent] = lv
            s = {k: int(v) for k, v in stats.items()}
            occs = " ".join(f"L{i + 1}={n}/{c}" for i, (n, c) in
                            enumerate(zip(counts, PILLAR_CAPS[1:])))
            log(f"cloud {agent}: {s['n_points_in_range']} pts, "
                f"{s['n_pillars_raw']} pillars ({s['n_pillars_dropped']} "
                f"dropped), {s['n_voxels_raw']} voxels "
                f"({s['n_voxels_dropped']} dropped), {occs}")
            if s["n_pillars_dropped"] or s["n_voxels_dropped"]:
                raise AssertionError(f"{agent} cloud overflows a cap")
            for n, c in zip(counts, PILLAR_CAPS[1:]):
                if n > c:
                    raise AssertionError(f"{agent} level occupancy {n} > {c}")

    # 3. each kernel against its plain version
    results = {}
    with torch.inference_mode():
        kernel_phases(levels["vehicle_"], results, dev)

    # 4. the main path
    head = model.pts_bbox_head
    finite = []
    hooks = [getattr(model, a + "model").pts_neck.register_forward_hook(
        lambda m, i, o: finite.append(("bev", torch.isfinite(o).all())))
        for a in ("vehicle_", "infrastructure_")]
    hooks.append(head.transformer.decoder.register_forward_hook(
        lambda m, i, o: finite.append(("decoder", torch.isfinite(o).all()))))

    with torch.inference_mode():
        main_path.frame(model, batch)  # warm-up (first-launch costs)
        finite.clear()
        _build.reset_counts()
        times = []
        for _ in range(N_FRAMES):
            t0 = time.perf_counter()
            task_outs, dec = main_path.frame(model, batch)
            times.append((time.perf_counter() - t0) * 1e3)
        launches = dict(_build.launch_counts)
    for h in hooks:
        h.remove()
    bad = [name for name, ok in finite if not bool(ok)]
    # per frame: each agent's BEV map and each agent's decoder pass
    if bad or len(finite) != 4 * N_FRAMES:
        raise AssertionError(f"non-finite outputs before nan_to_num: {bad}")
    for k, v in task_outs[0].items():
        if not bool(torch.isfinite(v).all()) or v.shape[:3] != (6, 1, 900):
            raise AssertionError(f"task output {k} {tuple(v.shape)}")
    if dec.scores.shape != (300,) or dec.boxes.shape != (300, 9) or not bool(
            torch.isfinite(dec.boxes).all()):
        raise AssertionError("decode did not give 300 finite slots")
    log(f"main path: {N_FRAMES} frames, ms/frame "
        f"{' '.join(f'{t:.1f}' for t in times)} (mean "
        f"{sum(times) / len(times):.1f}), {int(dec.valid.sum())}/300 valid "
        f"slots, launches {launches}")
    for name in _build.KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the path")

    # 5. slice parity (small config): GPU kernels vs CPU plain, float32
    small = build_detector(tiny_preset(**SMALL_COOP_PRESET),
                           extractor_kwargs=SMALL_COOP_EXTRACTOR,
                           head_kwargs=SMALL_COOP_HEAD)
    random_init_(small, torch.Generator().manual_seed(SEED))
    sb = {k: torch.from_numpy(v) for k, v in small_coop_batch().items()}
    with torch.inference_mode():
        cpu_outs, _ = small(sb)
        gpu_model = copy.deepcopy(small).to(dev)
        before = dict(_build.launch_counts)
        gpu_outs, _ = gpu_model({k: v.to(dev) for k, v in sb.items()})
    used = {k: _build.launch_counts[k] - before[k] for k in before}
    worst = 0.0
    for k, ref in cpu_outs[0].items():
        got = gpu_outs[0][k].cpu()
        worst = max(worst, float((got - ref).abs().max()) /
                    max(1.0, float(ref.abs().max())))
    log(f"slice parity (small coop detector, float32, GPU kernels vs CPU "
        f"plain): max err {worst:.3e} of max(1, max|ref|) (tol "
        f"{SLICE_TOL:g}), kernel launches {used}")
    if worst > SLICE_TOL or min(used.values()) <= 0:
        raise AssertionError("slice parity failed")

    kernels = []
    for name in _build.KERNELS:
        src, replaces = SOURCES[name]
        r = results[name]
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces, launches=launches[name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
