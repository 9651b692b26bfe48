#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (cmtcoop_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):
  1. the device: its name and `nvidia-smi` name / power limit;
  2. the kernel build (nvcc, sm_90a) and its seconds;
  3. each hand-written kernel against its plain PyTorch version on the card,
     at the main paths' shapes (kernels 1 and 2 at every conv of the pillar
     encoder on each agent's cloud, the 13 of `PILLAR_CONVS` x 2, with the
     neighbour maps and occupancy of the benchmark clouds, through the
     wrapper the eval encoder calls, weights packed once and rows compacted
     once per level, two bf16 calls bit-equal, each down conv's folded
     occupancy (`cmt_pillar_occ_fold`) equal to `occ_downsample`'s;
     kernel 4 at every shape the fusion path gives it, 20
     VoVNet stage shapes and the head, on operands packed once as the
     eval modules hold them, and its wrappers' host cost per launch;
     kernel 6 likewise at all 14 of the fusion path's OSA aggregate shapes;
     kernel 3 at 900 queries x the fusion path's 44400 and 36400 and the
     LiDAR path's 32400 keys, two calls bit-equal, its wrapper's host us
     a launch; kernels 7 and 8 at the train step's cross-attentions, 1540
     queries x 44400 and 36400 keys at dropout 0.1 and x 44400 at 0,
     kernel 7's out, m and l and kernel 8's dq and d(k_bias) bit-equal
     across two calls, and at dropout 0.1 kernel 7's (out, m, l) through
     kernel 8 against the plain forward and backward; all with a quarter
     of the keys at NEG_INF), in bfloat16 (and
     float32 at one or two cases a kernel), with error, tolerance and
     time, beside the least time the card could take for the same work
     (bytes over 3.35 TB/s, bf16 operations over 989 TFLOP/s, or for the
     flash kernels one exponential a score over 3.9 T/s, H100 SXM) and one
     PyTorch library call that computes the same function, where there is
     one; the fused neighbour map (kernel 9) at every map of the pillar
     encoder on both clouds (7 + 7) and of the gather encoder on the
     vehicle cloud (8, the stage-0 submanifold map the largest), each map's
     inputs captured from the encoder, with its tiles' bracket widths
     (p50, p99, max) and `torch.searchsorted` on the plain version's
     prepared targets as the library call (the compare-count alone), and
     each encoder's map builders run once under
     `torch.cuda.set_sync_debug_mode("error")`; and the row copy (kernel
     10) at (40960, 768) in bfloat16 and float32; both bit-equal to their
     plain versions, kernel 10 also timed in turns with clone() over 21
     repeats (medians and IQRs);
  4. the eval main paths, each through `build_detector` at full width in
     bfloat16 with seeded random weights, on the benchmark batch (two
     65536-point ray-cast clouds, seed 0): `cmt_lidar_coop_tumtraf`, the
     same with the gather sparse encoder (main_path.py `GATHER_PATH`), then
     the flagship `cmt_fusion_coop_tumtraf` (plus 1 vehicle and 3
     infrastructure cameras at 640x1600). Per path: zero pillar and voxel
     cap drops at every level (on the gather path zero voxel drops and no
     downsample with more output sites than its stage cap), warm-up plus 3
     timed frames of forward and top-300 decode, finite BEV maps (and CPFPN
     outputs) and decoder outputs, the launch count of every kernel of the
     path above zero and of every other kernel zero; on the fusion path
     memories of 36400 (vehicle) and 44400 (infrastructure) tokens, and
     kernel 3's, 4's and 6's launches counted per shape, which weight
     phase 3's kernel, library (SDPA; cuDNN; cat + bf16 matmul) and bound
     times into sums per fusion frame (kernel 3's per LiDAR frame too);
     kernels 1 and 2's, on the LiDAR and fusion paths, weight phase 3's
     kernel, plain and bound times of both clouds into sums per frame;
     kernel 9's, exactly one launch a map (14 a LiDAR or fusion frame, 16
     a gather frame, 14 a train step), weight its times into sums per
     LiDAR, gather and fusion frame and per train step.
     Between
     the gather and the fusion paths, a float32 check at full width: the
     gather encoder against the pillar encoder on the same weights and the
     vehicle cloud (they compute the same function), max |gather - pillar|
     / max |pillar| of the BEV maps within GATHER_TOL;
  5. the train path: the full-width `cmt_fusion_coop_tumtraf` train step
     (main_path.py `build_train_path`: DN with 128 GT slots, dropout 0.1,
     grid mask, Hungarian loss, backward, clipped AdamW, bfloat16), a
     warm-up plus 3 timed steps: finite losses and gradient norms, a
     gradient for every parameter, VoVNet's running statistics unchanged
     and SECOND's and the pillar encoder's moved, every parameter moved,
     zero cap drops, peak memory, kernels 7 and 8 launched and kernels 1 to
     6 not, and their launches per shape weighting phase 3's times into
     sums per train step;
  6. slice parity: the small LiDAR (pillar and gather encoders) and fusion
     detectors of the CPU parity tests (cmtcoop_tpu_torch/configs/presets.py
     `SMALL_COOP_*`, `SMALL_GATHER_EXTRACTOR`, `SMALL_FUSION_*`), the GPU
     forward (kernels, float32) against the CPU
     forward (plain versions) on the same weights and inputs; and one train
     step of the small fusion detector (dropout 0), GPU (kernels 7 and 8)
     against CPU, its loss dict and every gradient;
  7. the training runtime, on the preset's own widths and caps of
     `cmt_fusion_coop_tumtraf` (bfloat16) and the synthetic stream of
     data/synthetic.py: the port's CLI (`tools/train.py`, `main(argv)`)
     trains 4 steps, logging every step: 4 finite `metrics.jsonl` rows,
     checkpoints at steps 2 and 4, kernels 7, 8 and 9 launched and 1 to 6
     not; a second `Trainer` resumes from step 2 on the stream from its
     third batch: step 3's losses bit-equal to the first run's, every loss
     term and gradient norm of steps 3 and 4 within RESUME_TOL relative
     (both runs under PyTorch's deterministic algorithms), keep-1
     checkpoints leaving only the newest; its eval hook at step 4 runs the
     eval runner (`run_eval`, a separate eval-mode detector in bfloat16
     loaded with the trained state_dict) over a 2-sample synthetic val
     set scored by the nusc protocol: finite mAP and NDS, kernels 1, 2, 3,
     4, 6 and 9 launched; after one more train step the held eval model,
     reloaded, gives the boxes of a fresh eval model loaded with the same
     state_dict, bit for bit (its packed operands follow the weights);
     3 more Trainer steps against the bare step on the same batch; a
     spawned `PrefetchLoader` after CUDA init yields the thread mode's
     stream. It prints each checkpoint save's ms and bytes, the restore
     ms, the Trainer's and the bare step's ms/step (phase 5's beside
     them), eval ms/sample and the phase's peak memory, with the card's
     name and power limit, as one `{"runtime": ...}` JSON line.

Before the last line come a JSON object with one entry per kernel (its
launches on each main path and on phase 7's Trainer and eval runner, its
worst bfloat16 error, its first case's kernel, plain and library times
and its bound, and `cases`: those numbers for every bf16 case) and the
card's name and power limit from `nvidia-smi`; the last line is `{"ok":
true, "device": {...}}`. Without a CUDA device, or run outside a
checkout, it exits non-zero and prints no result.
"""
import copy
import json
import math
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
SEED = 0
N_FRAMES = 3
# max |kernel - plain| / max |plain| allowed: float32 differs only by
# summation order; bfloat16 rounds the outputs (2^-8 relative) and the
# plain versions round one more intermediate, so a few output ulps
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SLICE_TOL = 1e-3  # float32 GPU vs CPU over the whole small detector
# float32 gather vs pillar encoder at full width, of max |pillar BEV|: the
# same products summed in another order through 21 convs
GATHER_TOL = 1e-3
# the small train step, float32, GPU vs CPU: each loss term to TRAIN_TOL
# relative, each gradient to TRAIN_TOL of its max |CPU grad| + 1e-6 (the
# gather convs' scatter-add backward sums in another order on the card)
TRAIN_TOL = 2e-3
# H100 SXM published peaks: HBM bytes/s, dense bf16 tensor-core FLOP/s,
# and exponentials/s on the special-function units (the published rate of
# 16 a clock an SM: 132 SMs at 1.83 GHz); one exponential a softmax score
# is the flash kernels' other floor at Dh 32
PEAK_BYTES, PEAK_FLOPS, PEAK_EXP = 3.35e12, 989e12, 3.9e12
# the decoder's cross-attention memories: (keys, the path whose launches
# weight the case); 900 queries in eval, 1540 (with DN) in training
EVAL_ATTN = ((44400, "fusion"), (36400, "fusion"), (32400, "lidar"))
TRAIN_ATTN = ((44400, 0.1, "train"), (36400, 0.1, "train"),
              (44400, 0.0, None))
ATTN_Q = 1540
# kernel 4's shapes on the fusion path, (views, H, W, Cin, Cout, where):
# VoVNet-99's OSA 3x3 convs per stage (1 vehicle and 3 infrastructure views
# at 640x1600) and the head's shared_conv. Phase 3 times each; phase 4
# counts the launches at each in the fusion path's run, which must launch
# at these shapes and no other, and weights the times by those counts
CONV_PATH_SHAPES = [(1, 180, 180, 512, 256, "head")] + [
    (v, h, w, cin, cout, f"stage {st}")
    for v in (1, 3)
    for st, h, w, cin, cout in (
        (2, 160, 400, 128, 128), (3, 80, 200, 256, 160),
        (3, 80, 200, 160, 160), (3, 80, 200, 512, 160),
        (4, 40, 100, 512, 192), (4, 40, 100, 768, 192),
        (4, 40, 100, 192, 192), (5, 20, 50, 768, 224),
        (5, 20, 50, 1024, 224), (5, 20, 50, 224, 224))]
# kernel 6's shapes on the fusion path, (views, H, W, parts' channels, Cout,
# where): the aggregate of each OSA block of VoVNet-99 (a stage's first
# block takes the previous stage's output as its first part, the others
# their own block's input; five conv outputs follow), timed and weighted as
# kernel 4's are
AGG_PATH_SHAPES = [
    (v, h, w, (cin,) + (ch,) * 5, cout, f"stage {st}{which}")
    for v in (3, 1)
    for st, which, h, w, cin, ch, cout in (
        (2, "", 160, 400, 128, 128, 256),
        (3, " first", 80, 200, 256, 160, 512),
        (3, " rest", 80, 200, 512, 160, 512),
        (4, " first", 40, 100, 512, 192, 768),
        (4, " rest", 40, 100, 768, 192, 768),
        (5, " first", 20, 50, 768, 224, 1024),
        (5, " rest", 20, 50, 1024, 224, 1024))]

SOURCES = {
    "pillar_conv_kb9": ("cmtcoop_tpu_torch/csrc/pillar_conv.cu",
                        "cmtcoop_tpu/ops/pillar_fused.py:328"),
    "pillar_conv_kb1": ("cmtcoop_tpu_torch/csrc/pillar_conv.cu",
                        "cmtcoop_tpu/ops/pillar_fused.py:198"),
    "flash_attention_packed": ("cmtcoop_tpu_torch/csrc/flash_train.cu",
                               "cmtcoop_tpu/ops/attention.py:214"),
    "conv3x3_bn_relu": ("cmtcoop_tpu_torch/csrc/conv3x3.cu",
                        "cmtcoop_tpu/ops/conv_cf.py:89"),
    "conv3x3_bn_relu_resid": ("cmtcoop_tpu_torch/csrc/conv3x3.cu",
                              "cmtcoop_tpu/ops/conv_cf.py:184"),
    "osa_aggregate": ("cmtcoop_tpu_torch/csrc/osa_agg.cu",
                      "cmtcoop_tpu/ops/conv_cf.py:273"),
    "flash_train_fwd": ("cmtcoop_tpu_torch/csrc/flash_train.cu",
                        "cmtcoop_tpu/ops/attention.py:73"),
    "flash_train_bwd_dq": ("cmtcoop_tpu_torch/csrc/flash_train.cu",
                           "cmtcoop_tpu/ops/attention.py:309"),
    "flash_train_bwd_dkv": ("cmtcoop_tpu_torch/csrc/flash_train.cu",
                            "cmtcoop_tpu/ops/attention.py:354"),
    "neighbor_map": ("cmtcoop_tpu_torch/csrc/sorted_lookup.cu",
                     "cmtcoop_tpu/ops/lookup_kernel.py:32"),
    "rows_copy": ("cmtcoop_tpu_torch/csrc/rows_copy.cu",
                  "cmtcoop_tpu/ops/pillar_fused.py:59"),
}


# what runs each kernel's bf16 cases on the card (its `impl` in the
# kernels line)
IMPLS = {
    "pillar_conv_kb9": "bf16: tensor cores, wgmma, A gathered by cp.async "
                       "through the neighbour map, B by TMA "
                       "(pillar_tc::pillar_conv_tc_kernel); float32: CUDA "
                       "cores",
    "pillar_conv_kb1": "bf16: tensor cores, wgmma, A gathered by cp.async, "
                       "B by TMA (pillar_tc::pillar_conv_tc_kernel); "
                       "float32: CUDA cores",
    "flash_attention_packed": "bf16 Dh 32: tensor cores, wgmma + TMA "
                              "(kernel 7's fwd_tc::fwd_kernel on views, "
                              "dropout off, split-KV, merge_kernel); "
                              "float32: CUDA cores (flash_attention.cu)",
    "conv3x3_bn_relu": "bf16: tensor cores, wgmma + TMA; float32: CUDA "
                       "cores",
    "conv3x3_bn_relu_resid": "bf16: tensor cores, wgmma + TMA; float32: "
                             "CUDA cores",
    "osa_aggregate": "bf16: tensor cores, wgmma + TMA; float32: CUDA cores",
    "flash_train_fwd": "bf16 Dh 32: tensor cores, wgmma + TMA "
                       "(fwd_tc::fwd_kernel, split-KV, merge_kernel in "
                       "split order); float32: CUDA cores",
    "flash_train_bwd_dq": "bf16 Dh 32: tensor cores, wgmma + TMA "
                          "(bwd_tc::dq_kernel, split keys); float32: CUDA "
                          "cores",
    "flash_train_bwd_dkv": "bf16 Dh 32: tensor cores, wgmma + TMA "
                           "(bwd_tc::dkv_kernel); float32: CUDA cores",
    "neighbor_map": "CUDA cores: one launch a map, queries formed in "
                    "registers, each tile's tap run bracketed by a warp's "
                    "32-ary ballot search, the tile's rows staged in shared "
                    "memory (nmap::neighbor_map_kernel)",
    "rows_copy": "CUDA cores (16-byte vector copies)",
}


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, warmup=2, iters=5):
    """Device ms per call of `fn`: CUDA events around `iters` calls queued
    behind a ~20 ms spin of the device, so that a call shorter than its
    host-side launch cost is timed on the device, not on the host."""
    for _ in range(warmup):
        fn()
    torch.cuda._sleep(40_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters=20, repeats=7):
    """Host us per call of `fn` (the wrapper's cost to launch): the median
    over `repeats` blocks of `iters` calls, each block timed while the
    device works through a ~50 ms spin, so no call waits on it."""
    fn()
    blocks = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        blocks.append((time.perf_counter() - t0) * 1e6 / iters)
    torch.cuda.synchronize()
    return sorted(blocks)[repeats // 2]


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def bound(n_bytes, flops, exps=0.0):
    """(ms, what bounds it): the largest of the bytes over the memory rate,
    the bf16 operations over the tensor-core rate and the exponentials over
    the special-function rate (the last two are operations)."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = max(flops / PEAK_FLOPS, exps / PEAK_EXP)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def compare(name, shape_note, kernel, plain, make_inputs, results,
            exact_side=True, library=None, work=None,
            dtypes=(torch.bfloat16, torch.float32), info=None):
    """Kernel vs plain version on the same inputs, in each of `dtypes`;
    `make_inputs(dtype)` gives (args, kwargs). The first output is held to
    TOL of its max|plain|; side outputs are held equal (occupancy) or, with
    `exact_side=False`, each to TOL of its own max|plain|. Each bf16 case
    appends to the kernel's `cases` its numbers (those of the first output,
    `info` merged in): kernel and plain ms, the time of the call
    `library(*args, **kw)` returns (one PyTorch call computing the same
    function; None when there is none) and the bound from `work(*args,
    **kw)` -> (bytes, flops) or (bytes, flops, exponentials), the latter
    with both operation floors (`bound_tc_ms`, `bound_exp_ms`). The
    kernel's first case also gives its top-level numbers."""
    for dtype in dtypes:
        dname = str(dtype).split(".")[-1]
        args, kw = make_inputs(dtype)
        got = kernel(*args, **kw)
        ref = plain(*args, **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        if exact_side:
            for g, r in zip(got[1:], ref[1:]):
                if not torch.equal(g, r):
                    raise AssertionError(f"{name} {shape_note} {dname}: "
                                         "occupancy differs from the plain "
                                         "version")
        errs = []
        for i, (g, r) in enumerate(zip(got, ref)):
            if i and exact_side:
                break
            g, r = g.float(), r.float()
            if g.shape != r.shape or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{name} {shape_note} {dname}: output "
                                     f"{i} shape {tuple(g.shape)} vs "
                                     f"{tuple(r.shape)} or non-finite")
            errs.append((float((g - r).abs().max()), float(r.abs().max())))
        del got, ref
        ok = all(e <= TOL[dname] * p for e, p in errs)
        err, peak = errs[0]
        k_ms = cuda_ms(lambda: kernel(*args, **kw))
        p_ms = cuda_ms(lambda: plain(*args, **kw))
        side = "".join(f", output {i}: max_rel_err={e / max(p, 1e-30):.3e}"
                       for i, (e, p) in enumerate(errs) if i)
        log(f"kernel {name} [{shape_note}] {dname}: max_abs_err={err:.3e} "
            f"max_rel_err={err / max(peak, 1e-30):.3e} (max|plain|="
            f"{peak:.3e}, tol {TOL[dname]:g} of max|plain|){side} "
            f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {shape_note} {dname} disagrees")
        if dtype != torch.bfloat16:
            continue
        case = dict(note=shape_note, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                    library_ms=None if library is None
                    else cuda_ms(library(*args, **kw)), **(info or {}))
        w = work(*args, **kw)
        case["bound_ms"], case["bound_by"] = bound(*w)
        if len(w) == 3:
            case["bound_tc_ms"] = w[1] / PEAK_FLOPS * 1e3
            case["bound_exp_ms"] = w[2] / PEAK_EXP * 1e3
            case["bound_ops"] = ("exponentials" if case["bound_exp_ms"]
                                 >= case["bound_tc_ms"] else "tensor cores")
        record(results, name, case)
        floors = ("" if len(w) < 3 else
                  f"; tensor cores {case['bound_tc_ms']:.4f}, exponentials "
                  f"{case['bound_exp_ms']:.4f}")
        log(f"kernel {name} [{shape_note}] bfloat16: bound "
            f"{case['bound_ms']:.4f} ms ({case['bound_by']}{floors}), library "
            + ("none" if case["library_ms"] is None
               else f"{case['library_ms']:.4f} ms"))


def record(results, name, case):
    """Adds one bf16 case to a kernel's record: the worst error over its
    cases, the first case's times and bound at the top level."""
    rec = results.setdefault(name, dict(max_abs_err=0.0, cases=[]))
    rec["max_abs_err"] = max(rec["max_abs_err"], case["max_abs_err"])
    rec["cases"].append(case)
    for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
              "bound_ops"):
        if k in case:
            rec.setdefault(k, case[k])


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


# the pillar encoder's convs of one agent, as phase 3 times them: (what,
# level, Cin, Cout, kind); kind "subm" (occupancy given), "resid" (with the
# block's residual), "down" (stride 2 into the next level, occupancy
# folded), "out" (conv_out, KB 1)
PILLAR_CONVS = (("conv_input", 0, 5, 16, "subm"),
                ("L0 conv1", 0, 16, 16, "subm"), ("L0 conv2", 0, 16, 16,
                                                   "resid"),
                ("L0->L1 down", 0, 16, 32, "down"),
                ("L1 conv1", 1, 32, 32, "subm"), ("L1 conv2", 1, 32, 32,
                                                  "resid"),
                ("L1->L2 down", 1, 32, 64, "down"),
                ("L2 conv1", 2, 64, 64, "subm"), ("L2 conv2", 2, 64, 64,
                                                  "resid"),
                ("L2->L3 down", 2, 64, 128, "down"),
                ("L3 conv1", 3, 128, 128, "subm"), ("L3 conv2", 3, 128, 128,
                                                    "resid"),
                ("conv_out", 3, 128, 128, "out"))


def pillar_kernel_phases(clouds, results, dev):
    """Kernels 1 and 2 at every conv of the pillar encoder on each agent's
    cloud (`PILLAR_CONVS`), through the wrapper the eval encoder calls: the
    weights packed once (`pack_pillar_weight`), the active rows compacted
    once per level. Random features on the occupied input voxels and
    weights from SEED; each bf16 case also two calls bit-equal, and each
    down conv's occupancy folded by `cmt_pillar_occ_fold` equal to
    `occ_downsample`'s."""
    from cmtcoop_tpu_torch.ops import pillars as pu
    from cmtcoop_tpu_torch.ops.conv_cf import sm_count
    from cmtcoop_tpu_torch.ops.pillar_fused import (
        active_rows, fold_occupancy, fused_pillar_conv_packed,
        fused_pillar_conv_reference, pack_pillar_weight, pillar_conv_plan)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def plain(x, nbr, packed, rows=None, **kw):
        return fused_pillar_conv_reference(
            x, nbr, packed.source, kz=packed.kz, scale=packed.scale,
            bias=packed.bias, **kw)

    for agent, levels in clouds.items():
        rows = [active_rows(lv["occ"]) for lv in levels]
        ident = pu.identity_map(levels[3]["grid"])
        occ_final = pu.occ_downsample(levels[3]["occ"], ident, 3, 2, 0)
        rows_final = active_rows(occ_final)
        for what, li, cin, cout, kind in PILLAR_CONVS:
            lv = levels[li]
            occ_in = lv["occ"]
            kb = 1 if kind == "out" else 9
            kw = dict(relu=True)
            if kind == "down":
                nbr, occ_out, r = lv["nbr_dn"], levels[li + 1]["occ"], \
                    rows[li + 1]
                kw.update(z_stride=2, z_pad=lv["zpad"])
                if not torch.equal(fold_occupancy(occ_in, nbr, 3, 2,
                                                  lv["zpad"]), occ_out):
                    raise AssertionError(
                        f"cmt_pillar_occ_fold {agent}{what}: the folded "
                        f"occupancy differs from occ_downsample's")
            elif kind == "out":
                nbr, occ_out, r = ident, occ_final, rows_final
                kw.update(z_stride=2, z_pad=0)
            else:
                nbr, occ_out, r = lv["nbr"], occ_in, rows[li]
            kw.update(occ_out=occ_out, rows=r)
            x = randn(*occ_in.shape, cin) * occ_in[..., None]
            w = randn(3 * kb, cin, cout, scale=(3 * kb * cin) ** -0.5)
            scale, bias = 1.0 + 0.1 * randn(cout), 0.1 * randn(cout)
            resid = (randn(*occ_out.shape, cout) * occ_out[..., None]
                     if kind == "resid" else None)
            packs = {dt: pack_pillar_weight(w, scale, bias, dt)
                     for dt in (torch.bfloat16, torch.float32)}

            def inputs(dtype, x=x, nbr=nbr, kw=kw, resid=resid, packs=packs):
                a = dict(kw)
                if resid is not None:
                    a["residual"] = resid.to(dtype)
                return (x.to(dtype), nbr, packs[dtype]), a

            def work(x, nbr, packed, occ_in=occ_in, occ_out=occ_out,
                     residual=None, z_stride=1, z_pad=1, **_):
                """(bytes, flops) that this data needs: the input voxels in
                the receptive field of an occupied output voxel and the
                residual's occupied rows read once, the dense output
                written once (its zeros too), the map, the occupancy, the
                weight, scale and bias read once; the products of every
                occupied output voxel with the taps whose input voxel is
                occupied."""
                p_in, z_in = occ_in.shape
                p_out, z_out = occ_out.shape
                zo = torch.arange(z_out, device=x.device) * z_stride
                need = torch.zeros(p_in + 1, z_in + 2 * z_pad,
                                   dtype=torch.bool, device=x.device)
                padded = torch.nn.functional.pad(
                    torch.cat([occ_in, occ_in.new_zeros(1, z_in)]),
                    (z_pad, z_pad))
                taps = 0
                for j in range(nbr.shape[1]):
                    src = nbr[:, j].long()
                    for dz in range(packed.kz):
                        ps, zs = occ_out.nonzero(as_tuple=True)
                        need[src[ps], zo[zs] + dz] = True
                        taps += int(padded[src[ps], zo[zs] + dz].sum())
                need = need[:p_in, z_pad:z_pad + z_in]
                elt = x.element_size()
                n_occ = int(occ_out.sum())
                return (int(need.sum()) * packed.cin * elt
                        + (n_occ * packed.cout * elt if residual is not None
                           else 0)
                        + occ_out.numel() * packed.cout * elt
                        + nbytes(nbr, occ_out, packed.scale, packed.bias)
                        + packed.source.numel() * elt,
                        2.0 * taps * packed.cin * packed.cout)

            p_out, z_out = occ_out.shape
            shape = [kb, *occ_in.shape, cin, p_out, z_out, cout,
                     kind == "resid"]
            name = "pillar_conv_kb9" if kb == 9 else "pillar_conv_kb1"
            note = (f"{agent.rstrip('_')} {what} P{occ_in.shape[0]} "
                    f"Z{occ_in.shape[1]} -> P{p_out} Z{z_out} {cin}->{cout}")
            compare(name, note, fused_pillar_conv_packed, plain, inputs,
                    results, work=work,
                    info=dict(shape=shape, agent=agent.rstrip("_"),
                              conv=what))
            case = results[name]["cases"][-1]
            args, a = inputs(torch.bfloat16)
            first = fused_pillar_conv_packed(*args, **a)
            second = fused_pillar_conv_packed(*args, **a)
            if not torch.equal(first, second):
                raise AssertionError(f"{name} {note}: two bf16 calls differ")
            plan = pillar_conv_plan(kb, 3, cin, cout, p_out * z_out,
                                    sm_count(dev))
            case.update(bit_equal=True, plan=plan.bm)
            if kind == "down":
                case["occ_fold_equal"] = True
            log(f"kernel {name} [{note}] bfloat16: two calls bit-equal"
                + ("; folded occupancy equal" if kind == "down" else "")
                + f" (rows a tile {plan.bm})")


def sdpa(q, k, v, k_bias, dropout_p=0.0):
    """The library call: scaled_dot_product_attention on (B, H, N, Dh) with
    the per-key mask as a boolean mask."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=(k_bias == 0)[:, None, None, :],
        dropout_p=dropout_p)


def kernel_phases(results, dev):
    from cmtcoop_tpu_torch.models.layers import (AggPack, BatchNorm,
                                                 Conv2d, ConvBNReLU)
    from cmtcoop_tpu_torch.ops import pillars as pu
    from cmtcoop_tpu_torch.ops.attention import (
        NEG_INF, flash_attention_packed, flash_attention_packed_reference)
    from cmtcoop_tpu_torch.ops.conv_cf import (conv3x3_bn_relu,
                                               conv3x3_bn_relu_packed,
                                               conv3x3_bn_relu_reference,
                                               osa_agg_plan, osa_agg_plans,
                                               osa_aggregate,
                                               osa_aggregate_packed,
                                               osa_aggregate_reference,
                                               pack_conv3x3_weight,
                                               pack_osa_weight, sm_count)

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    # kernel 3 at the decoder's memories (the fusion path's two, the LiDAR
    # and gather paths' one): q scaled so the softmax peaks (logit std 4), a
    # quarter of the keys masked with NEG_INF as padded keys are; float32
    # (the CUDA-core route) at the first. Two calls must give the same
    # bits.
    def heads(x, h):
        return x.view(x.shape[0], -1, h, x.shape[2] // h).transpose(1, 2)

    for i, (nk, path) in enumerate(EVAL_ATTN):
        q, k, v = (randn(1, n, 256, scale=s) for n, s in ((900, 4.0),
                                                          (nk, 1.0),
                                                          (nk, 1.0)))
        masked = torch.rand(1, nk, generator=gen, device=dev) < 0.25
        kbias = torch.where(masked, NEG_INF, 0.0)
        compare("flash_attention_packed",
                f"q900 k{nk} 8x32, 1/4 keys masked ({path})",
                flash_attention_packed, flash_attention_packed_reference,
                lambda dt: ((q.to(dt), k.to(dt), v.to(dt), kbias, 8), {}),
                results,
                library=lambda q_, k_, v_, kb, h: lambda: sdpa(
                    heads(q_, h), heads(k_, h), heads(v_, h), kb),
                work=lambda q_, k_, v_, kb, h: (
                    nbytes(q_, k_, v_, kb) + nbytes(q_),
                    4.0 * q_.shape[1] * k_.shape[1] * q_.shape[2],
                    float(q_.shape[1] * k_.shape[1] * h)),
                dtypes=((torch.bfloat16, torch.float32) if i == 0
                        else (torch.bfloat16,)),
                info=dict(shape=[900, nk, 8, 32], path=path))
        qb, kb16, vb = (x.to(torch.bfloat16) for x in (q, k, v))
        first = flash_attention_packed(qb, kb16, vb, kbias, 8)
        if not torch.equal(first, flash_attention_packed(qb, kb16, vb,
                                                         kbias, 8)):
            raise AssertionError(f"flash_attention_packed k{nk}: two calls "
                                 "differ")
        log(f"kernel flash_attention_packed [q900 k{nk}] bfloat16: two calls "
            "bit-equal")
        if i == 0:  # the wrapper's host cost a launch: eval is host-bound
            us = host_us(lambda: flash_attention_packed(qb, kb16, vb, kbias,
                                                        8))
            results["flash_attention_packed"]["host_us_per_launch"] = dict(
                wrapper=us)
            log(f"kernel flash_attention_packed host us per launch (q900 "
                f"k{nk}, bfloat16): {us:.1f}")
        del q, k, v, qb, kb16, vb, first

    # kernels 4 and 5 are timed as the main path calls them: on operands
    # packed once (`conv3x3_bn_relu_packed`); the plain version takes the
    # pack's source weight and folded BN
    def conv_plain(x, packed, residual=None):
        return conv3x3_bn_relu_reference(x, packed.source, packed.scale,
                                         packed.bias, residual=residual)

    def conv_work(x, packed, residual=None):
        n, h, w, cin = x.shape
        return (nbytes(x, packed.scale, packed.bias, residual)
                + packed.source.numel() * x.element_size()
                + n * h * w * packed.cout * x.element_size(),
                2.0 * n * h * w * cin * packed.cout * 9)

    def conv_library(x, packed, residual=None):
        w = packed.source.to(x.dtype)
        return lambda: torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w,
                                                  padding=1)

    def conv_case(name, note, v, h, w, cin, cout, with_resid, fp32):
        x = randn(v, h, w, cin)
        wt = randn(cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
        s, b = 1.0 + 0.1 * randn(cout), 0.1 * randn(cout)
        res = randn(v, h, w, cout) if with_resid else None

        def inputs(dt):
            kw = {} if res is None else dict(residual=res.to(dt))
            return (x.to(dt), pack_conv3x3_weight(wt, s, b, dt)), kw

        compare(name, note, conv3x3_bn_relu_packed, conv_plain, inputs,
                results, library=conv_library, work=conv_work,
                dtypes=((torch.bfloat16, torch.float32) if fp32
                        else (torch.bfloat16,)),
                info=dict(shape=[v, h, w, cin, cout]))
        return x.to(torch.bfloat16), wt, s, b

    # kernel 4 at every shape of the fusion path (float32 too at the first
    # two and at kernel 5's case)
    for v, h, w, cin, cout, note in CONV_PATH_SHAPES:
        last = conv_case("conv3x3_bn_relu",
                         f"{note} V{v} {h}x{w} {cin}->{cout}", v, h, w, cin,
                         cout, False,
                         (v, h, w, cin) in ((1, 180, 180, 512),
                                            (3, 80, 200, 160)))
    conv_case("conv3x3_bn_relu_resid", "V3 80x200 160->160 + residual", 3,
              80, 200, 160, 160, True, True)
    # the host cost per launch at the last shape (stage 5 V3): the wrapper
    # on a held pack, an eval module (its pack's cache check included), and
    # the wrapper that packs per call
    x, wt, s, b = last
    packed = pack_conv3x3_weight(wt, s, b, x.dtype)
    module = ConvBNReLU(wt.shape[1], wt.shape[0]).to(dev).eval()
    us = dict(packed=host_us(lambda: conv3x3_bn_relu_packed(x, packed)),
              eval_module=host_us(lambda: module(x)),
              packing_per_call=host_us(lambda: conv3x3_bn_relu(x, wt, s, b)))
    results["conv3x3_bn_relu"]["host_us_per_launch"] = us
    log(f"kernel conv3x3_bn_relu host us per launch ({tuple(x.shape)} -> "
        f"{wt.shape[0]}): packed once {us['packed']:.1f}, eval module "
        f"{us['eval_module']:.1f}, packing per call "
        f"{us['packing_per_call']:.1f}")

    # kernel 6 likewise, through the packed wrapper; the plain version
    # takes the pack's source weight and folded BN, the library call is
    # the cat and one bf16 matmul (no fold, bias or ReLU)
    def agg_plain(parts, packed):
        return osa_aggregate_reference(parts, packed.source, packed.scale,
                                       packed.bias)

    def agg_work(parts, packed):
        v, h, w = parts[0].shape[:3]
        esize = parts[0].element_size()
        return (nbytes(*parts, packed.scale, packed.bias)
                + packed.source.numel() * esize
                + v * h * w * packed.cout * esize + v * packed.cout * 4,
                2.0 * v * h * w * packed.source.shape[0] * packed.cout)

    def agg_library(parts, packed):
        w = packed.source.to(parts[0].dtype)
        return lambda: torch.cat(parts, dim=-1).reshape(-1, w.shape[0]) @ w

    def agg_case(note, v, h, w, chans, cout, fp32):
        parts = [randn(v, h, w, c) for c in chans]
        wt = randn(sum(chans), cout, scale=sum(chans) ** -0.5)
        s, b = 1.0 + 0.1 * randn(cout), 0.1 * randn(cout)
        compare("osa_aggregate", note, osa_aggregate_packed, agg_plain,
                lambda dt: (([p.to(dt) for p in parts],
                             pack_osa_weight(wt, s, b, chans, dt)), {}),
                results, exact_side=False, library=agg_library,
                work=agg_work,
                dtypes=((torch.bfloat16, torch.float32) if fp32
                        else (torch.bfloat16,)),
                info=dict(shape=[v, h, w, *chans, cout]))
        # every tile the bf16 kernel takes, timed on the same inputs, beside
        # the plan's choice
        xs = [p.to(torch.bfloat16) for p in parts]
        packed = pack_osa_weight(wt, s, b, chans, torch.bfloat16)
        plans = {f"128x{p.bn}": cuda_ms(
            lambda p=p: osa_aggregate_packed(xs, packed, p))
            for p in osa_agg_plans(v, h * w, chans, cout)}
        chosen = osa_agg_plan(v, h * w, tuple(chans), cout, sm_count(dev))
        case = results["osa_aggregate"]["cases"][-1]
        case.update(plan=f"128x{chosen.bn}", plans_ms=plans)
        log(f"kernel osa_aggregate [{note}] bfloat16 ms by tile (pixels x "
            f"columns): " + ", ".join(f"{k} {t:.4f}" for k, t in
                                      plans.items())
            + f"; the plan takes {case['plan']}")
        return xs, wt, s, b

    # float32 too (the CUDA-core route) at stage 2 V3 and stage 4 rest V3
    for v, h, w, chans, cout, note in AGG_PATH_SHAPES:
        last = agg_case(f"{note} V{v} {h}x{w} {chans[0]}+5x{chans[1]}->"
                        f"{cout} (agg; output 1 = gap)", v, h, w, chans,
                        cout, v == 3 and note in ("stage 2", "stage 4 rest"))
    # the host cost per launch at the last shape (stage 5 V1): the wrapper
    # on a held pack, the eval module's path (its pack's cache check
    # included: the 1x1 conv's weight, its BN), and packing per call
    parts, wt, s, b = last
    chans = [p.shape[-1] for p in parts]
    packed = pack_osa_weight(wt, s, b, chans, torch.bfloat16)
    conv = Conv2d(sum(chans), wt.shape[1], 1).to(dev)
    bn = BatchNorm(wt.shape[1], 1e-5).to(dev)
    pack = AggPack()
    us = dict(packed=host_us(lambda: osa_aggregate_packed(parts, packed)),
              eval_module=host_us(lambda: osa_aggregate_packed(
                  parts, pack(conv.weight, bn, chans, torch.bfloat16))),
              packing_per_call=host_us(lambda: osa_aggregate(parts, wt, s,
                                                             b)))
    results["osa_aggregate"]["host_us_per_launch"] = us
    log(f"kernel osa_aggregate host us per launch ({tuple(parts[0].shape)} "
        f"x {len(parts)} parts -> {wt.shape[1]}): packed once "
        f"{us['packed']:.1f}, eval module {us['eval_module']:.1f}, packing "
        f"per call {us['packing_per_call']:.1f}")


def train_kernel_phases(results, dev):
    """Kernels 7 and 8 against their plain versions at the train step's
    cross-attentions (`TRAIN_ATTN`: both memories at the path's dropout
    0.1, the infrastructure one at 0 too, so the dropout hash's cost shows;
    float32 at the first); the backward takes the plain forward's (out, m,
    l), and its dq and d(k_bias) must be bit-equal across two calls.
    Outside inference mode: the library call for kernel 8 is the autograd
    backward of scaled_dot_product_attention."""
    from cmtcoop_tpu_torch.ops import attention as ta
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    b, h, dh, seed = 1, 8, 32, SEED + 7

    def views(dt, *xs):
        return [x.to(dt).view(b, -1, h, dh).transpose(1, 2) for x in xs]

    def fwd_work(q_, k_, v_, kb_, *rest, **kw):
        nq, nk = q_.shape[2], k_.shape[2]
        return (nbytes(q_, k_, v_, kb_) + nbytes(q_) + 8 * b * h * nq,
                4.0 * b * h * nq * nk * dh, float(b * h * nq * nk))

    def bwd_work(passes, out_bytes):
        def work(q_, k_, v_, kb_, out, m, l, do, *rest):
            # m and l in, delta (the size of m) in, the outputs written
            nq, nk = q_.shape[2], k_.shape[2]
            return (nbytes(q_, k_, v_, kb_, m, l, do) + nbytes(m)
                    + out_bytes(q_, k_),
                    passes * 2.0 * b * h * nq * nk * dh,
                    float(b * h * nq * nk))
        return work

    def sdpa_backward(q_, k_, v_, kb_, out, m, l, do, rate, seed_):
        """The backward of one scaled_dot_product_attention call with the
        same mask and dropout rate (dq, dk and dv together)."""
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (q_, k_, v_)]
            o = sdpa(*leaves, kb_, rate)
        return lambda: torch.autograd.grad(o, leaves, do, retain_graph=True)

    for i, (nk, rate, path) in enumerate(TRAIN_ATTN):
        q, k, v, dout = (
            torch.randn(b, n, h * dh, generator=gen, device=dev) * s
            for n, s in ((ATTN_Q, 4.0), (nk, 1.0), (nk, 1.0), (ATTN_Q, 1.0)))
        masked = torch.rand(b, nk, generator=gen, device=dev) < 0.25
        kb = torch.where(masked, ta.NEG_INF, 0.0)
        note = f"q{ATTN_Q} k{nk} 8x32, 1/4 keys masked, dropout {rate:g}"
        info = dict(shape=[ATTN_Q, nk, h, dh], rate=rate, path=path)
        dtypes = ((torch.bfloat16, torch.float32) if i == 0
                  else (torch.bfloat16,))
        compare("flash_train_fwd", note + " (outputs 1, 2 = m, l)",
                ta.flash_attention_kvmask,
                ta.flash_attention_kvmask_reference,
                lambda dt, r=rate: ((*views(dt, q, k, v), kb, True, r, seed),
                                    {}),
                results, exact_side=False, work=fwd_work, dtypes=dtypes,
                info=info,
                library=lambda q_, k_, v_, kb_, st, r, sd: lambda: sdpa(
                    q_, k_, v_, kb_, r))
        train_forward_checks(ta, results, note, (*views(torch.bfloat16, q,
                                                        k, v), kb),
                             views(torch.bfloat16, dout)[0], rate, seed)

        prepared = {}

        def bwd_inputs(dt, r=rate):
            """The backward's inputs; kernel 8's argument block (and delta)
            is built from them once, and each launch is timed on it."""
            qv, kv, vv = views(dt, q, k, v)
            out, m, l = ta.flash_attention_kvmask_reference(qv, kv, vv, kb,
                                                            True, r, seed)
            args = (qv, kv, vv, kb, out, m, l, views(dt, dout)[0], r, seed)
            prepared["block"] = ta._bwd_args(*args)
            return args, {}

        compare("flash_train_bwd_dq", note,
                lambda q_, *a: ta._bwd_dq(prepared["block"][0], q_),
                lambda *a: ta.flash_attention_bwd_reference(*a)[0],
                bwd_inputs, results, exact_side=False, dtypes=dtypes,
                info=info, work=bwd_work(3, lambda q_, k_: nbytes(q_)),
                library=sdpa_backward)
        compare("flash_train_bwd_dkv", note + " (outputs dk, dv, dk_bias)",
                lambda q_, k_, v_, kb_, *a: ta._bwd_dkv(prepared["block"][0],
                                                        k_, kb_),
                lambda *a: ta.flash_attention_bwd_reference(*a)[1:],
                bwd_inputs, results, exact_side=False, dtypes=dtypes,
                info=info, work=bwd_work(4, lambda q_, k_: 2 * nbytes(k_)
                                         + 4 * b * h * k_.shape[2]),
                library=sdpa_backward)
        # dq and d(k_bias) twice on one bf16 block (`args` keeps the
        # tensors it points to alive)
        args, _ = bwd_inputs(torch.bfloat16)
        a, qv, kv = prepared["block"][0], args[0], args[1]
        dq0, dkb0 = ta._bwd_dq(a, qv), ta._bwd_dkv(a, kv, kb)[2]
        if not (torch.equal(dq0, ta._bwd_dq(a, qv))
                and torch.equal(dkb0, ta._bwd_dkv(a, kv, kb)[2])):
            raise AssertionError(f"flash_train_bwd {note}: two calls differ")
        log(f"kernel flash_train_bwd [{note}] bfloat16: dq and d(k_bias) "
            "bit-equal across two calls")
        del q, k, v, dout, prepared, args, a, dq0, dkb0
        torch.cuda.empty_cache()


def train_forward_checks(ta, results, note, qkv_kb, dout, rate, seed):
    """Kernel 7's bf16 route beyond `compare`: the one tile it is built at
    (`plan`, `plans_ms`: the case's own time); out, m and l bit-equal
    across two calls; and, with dropout, its (out, m, l) fed to kernel 8
    against the plain forward and backward (dq, dk, dv and d(k_bias), each
    within TOL of its max |plain|)."""
    case = results["flash_train_fwd"]["cases"][-1]
    case["plan"] = "{}x{}".format(*ta.FWD_TC_TILE)
    case["plans_ms"] = {case["plan"]: case["ms"]}
    first = ta.flash_attention_kvmask(*qkv_kb, True, rate, seed)
    again = ta.flash_attention_kvmask(*qkv_kb, True, rate, seed)
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"flash_train_fwd {note}: two calls differ")
    log(f"kernel flash_train_fwd [{note}] bfloat16: out, m and l bit-equal "
        "across two calls")
    if rate == 0.0:
        return
    got = ta.flash_attention_bwd(*qkv_kb, *first, dout, rate, seed)
    plain = ta.flash_attention_kvmask_reference(*qkv_kb, True, rate, seed)
    want = ta.flash_attention_bwd_reference(*qkv_kb, *plain, dout, rate,
                                            seed)
    rel = [float((g.float() - w.float()).abs().max())
           / max(float(w.float().abs().max()), 1e-30)
           for g, w in zip(got, want)]
    log(f"kernels flash_train_fwd -> flash_train_bwd [{note}] bfloat16 "
        "against the plain forward and backward: max_rel_err dq "
        "{:.3e}, dk {:.3e}, dv {:.3e}, dk_bias {:.3e} (tol {:g})".format(
            *rel, TOL["bfloat16"]))
    case["chain_max_rel_err"] = dict(zip(("dq", "dk", "dv", "dk_bias"), rel))
    if max(rel) > TOL["bfloat16"]:
        raise AssertionError(f"kernel 7 -> kernel 8 {note} disagrees with "
                             "the plain forward and backward")


def interleaved_ms(fns, repeats=21, iters=20):
    """{name: ms per call of each repeat} for the calls in `fns`, timed in
    turns (one `cuda_ms` of each a repeat), so that a drift of the card's
    clock falls on all of them alike."""
    times = {name: [] for name in fns}
    for _ in range(repeats):
        for name, fn in fns.items():
            times[name].append(cuda_ms(fn, iters=iters))
    return times


def median_iqr(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2], xs[(3 * n) // 4] - xs[n // 4]


def compare_exact(name, note, kernel, plain, args, results, library,
                  info=None):
    """A kernel whose outputs must be bit-equal to its plain version's on
    `args`; records the case's kernel, plain and library times (`library()`
    gives the timed call; each over 20 calls, as these kernels take
    microseconds), `info` and its bound (bytes: its tensor inputs read
    once, its outputs written once)."""
    got = kernel(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for i, (g, r) in enumerate(zip(got, ref)):
        if g.dtype != r.dtype or not torch.equal(g, r):
            raise AssertionError(f"{name} {note}: output {i} differs from "
                                 "the plain version")
    k_ms = cuda_ms(lambda: kernel(*args), iters=20)
    p_ms = cuda_ms(lambda: plain(*args), iters=20)
    log(f"kernel {name} [{note}]: bit-equal to the plain version, kernel "
        f"{k_ms:.4f} ms, plain {p_ms:.4f} ms")
    case = dict(note=note, max_abs_err=0.0, ms=k_ms, plain_ms=p_ms,
                library_ms=cuda_ms(library(), iters=20), **(info or {}))
    case["bound_ms"], case["bound_by"] = bound(nbytes(*args) + nbytes(*got),
                                               0.0)
    record(results, name, case)
    log(f"kernel {name} [{note}]: bound {case['bound_ms']:.4f} ms "
        f"({case['bound_by']}), library {case['library_ms']:.4f} ms")


def captured_maps(module, fn, *args, **kwargs):
    """The arguments of every `neighbor_map` that `fn(*args, **kwargs)`
    makes through `module`: the kernel's inputs exactly as the path gives
    them."""
    seen = []
    orig = module.neighbor_map

    def recording(*a):
        seen.append(a)
        return orig(*a)

    module.neighbor_map = recording
    try:
        fn(*args, **kwargs)
    finally:
        module.neighbor_map = orig
    return seen


def pillar_maps(enc, pcoords, pmask):
    """The pillar encoder's 7 neighbour maps and 3 downsample grids of one
    cloud, built as its forward builds them."""
    from cmtcoop_tpu_torch.main_path import PILLAR_CAPS
    from cmtcoop_tpu_torch.ops import pillars as pu
    d, h, w = enc.sparse_shape
    grid = pu.PillarGrid(pcoords, pmask, (h, w), d)
    keys = grid.linear_ids
    maps = [pu.pillar_neighbor_map(grid, keys=keys)]
    for cap in PILLAR_CAPS[1:]:
        out = pu.pillar_downsample_grid(grid, cap)
        maps.append(pu.pillar_conv_neighbor_map(grid, out, keys=keys))
        grid, keys = out, out.linear_ids
        maps.append(pu.pillar_neighbor_map(grid, keys=keys))
    return maps


def no_sync(what, fn, *args):
    """fn(*args) under `torch.cuda.set_sync_debug_mode("error")`: raises
    if it synchronises with the host."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log(f"{what}: no host synchronisation")
    return out


def neighbor_map_phases(model, batch, results):
    """Kernel 9 at every neighbour map of the pillar encoder on both clouds
    (7 each) and of the gather encoder on the vehicle cloud (8), each map's
    inputs captured from the encoder as its path calls it: bit-equal to the
    plain version, kernel / plain / library times, the bound and the
    bracket widths of its tiles' runs (`neighbor_map_walk`). The library call is
    the plain version's one `torch.searchsorted` on its prepared int64
    targets: the compare-count alone, without the query formation or the
    select. Each encoder's map builders also run once under
    `set_sync_debug_mode("error")`."""
    from cmtcoop_tpu_torch.main_path import SPARSE_CAPS
    from cmtcoop_tpu_torch.models.sparse_encoder import SparseEncoder
    from cmtcoop_tpu_torch.ops import lookup_kernel as lk
    from cmtcoop_tpu_torch.ops import pillars as pu
    from cmtcoop_tpu_torch.ops import sparse_utils as su
    calls = []
    for agent in ("vehicle_", "infrastructure_"):
        ext = getattr(model, agent + "model")
        enc = ext.pts_middle_encoder
        pillars = ext.pillarize(batch[agent + "points"][0],
                                batch[agent + "points_mask"][0])
        seen = captured_maps(pu, enc, *pillars, dtype=torch.bfloat16)
        # a subm map a level and a down map between levels
        want = 2 * len(enc.encoder_channels) - 1
        if len(seen) != want:
            raise AssertionError(f"{agent} pillar encoder built {len(seen)} "
                                 f"neighbour maps, not {want}")
        calls += [("pillar", agent, a) for a in seen]
        if agent == "vehicle_":
            no_sync("pillar encoder map builders (vehicle cloud)",
                    pillar_maps, enc, *pillars[:2])
    ext = model.vehicle_model
    vox = ext.voxelize(batch["vehicle_points"][0],
                       batch["vehicle_points_mask"][0])
    genc = SparseEncoder(sparse_shape=ext.pts_middle_encoder.sparse_shape,
                         stage_caps=SPARSE_CAPS)
    seen = captured_maps(su, genc.maps, vox.coords, vox.mask)
    # a subm map a stage, a down map after each but the last, conv_out's
    if len(seen) != 2 * len(genc.encoder_channels):
        raise AssertionError(f"gather encoder built {len(seen)} neighbour "
                             "maps, not two a stage")
    calls += [("gather", "vehicle_", a) for a in seen]
    no_sync("gather encoder map builders (vehicle cloud, SparseEncoder."
            "maps)", genc.maps, vox.coords, vox.mask)
    for enc_name, agent, args in calls:
        keys, coords, mask, shape, ks, st, pad = args
        _, widths = lk.neighbor_map_walk(*args)
        w = widths.float()
        brackets = (dict(p50=float(w.quantile(0.5)),
                         p99=float(w.quantile(0.99)), max=float(w.max()),
                         tile_runs=int(w.numel()))
                    if w.numel() else dict(p50=0.0, p99=0.0, max=0.0,
                                           tile_runs=0))
        q = lk.neighbor_queries(coords, mask, shape, ks, st, pad)
        q64 = q.reshape(-1, 1).long()
        targets = torch.where(q64 == lk.INT32_MAX, q64,
                              q64 + torch.arange(2, device=q.device))
        keys64 = keys.long()
        _, ks, st, _ = lk.geometry(shape, ks, st, pad)
        note = (f"{enc_name} {agent[:-1]} {ks} stride {st}: "
                f"{keys.shape[0]} keys, {coords.shape[0]} sites x "
                f"{q.shape[1]} taps")
        shape_key = (keys.shape[0], coords.shape[0]) + ks + st
        compare_exact("neighbor_map", note, lk.neighbor_map,
                      lk.neighbor_map_reference, args, results,
                      lambda: lambda: torch.searchsorted(keys64, targets),
                      info=dict(path=enc_name, agent=agent[:-1],
                                shape=shape_key, brackets=brackets))
        log(f"kernel neighbor_map [{note}]: bracket widths p50 "
            f"{brackets['p50']:.0f}, p99 {brackets['p99']:.0f}, max "
            f"{brackets['max']:.0f} keys over {brackets['tile_runs']} runs "
            "of a 128-site tile")


def rows_copy_phases(dev, results):
    """Kernel 10 at the packed rows of the JAX fallback branch, (40960,
    768), in bfloat16 and float32."""
    from cmtcoop_tpu_torch.ops.pillar_fused import (pin_rows,
                                                    pin_rows_reference)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    x = torch.randn(40960, 768, generator=gen, device=dev)
    for dt in (torch.bfloat16, torch.float32):
        xd = x.to(dt)
        note = f"(40960, 768) {str(dt).split('.')[-1]}"
        compare_exact("rows_copy", note, pin_rows, pin_rows_reference, (xd,),
                      results, lambda: xd.clone)
        # the re-measurement against clone(): both timed in turns, the
        # medians and interquartile ranges of 21 repeats
        t = interleaved_ms({"kernel": lambda: pin_rows(xd),
                            "clone": xd.clone})
        (km, kiqr), (cm, ciqr) = median_iqr(t["kernel"]), median_iqr(
            t["clone"])
        results["rows_copy"]["cases"][-1]["interleaved"] = dict(
            repeats=len(t["kernel"]), kernel_median_ms=km, kernel_iqr_ms=kiqr,
            clone_median_ms=cm, clone_iqr_ms=ciqr)
        log(f"kernel rows_copy [{note}] interleaved with clone(), "
            f"{len(t['kernel'])} repeats: kernel median {km:.4f} ms (IQR "
            f"{kiqr:.4f}), clone {cm:.4f} ms (IQR {ciqr:.4f}); the kernel "
            + ("loses by more than the spread" if km - cm > max(kiqr, ciqr)
               else "is no slower than clone() within the spread"))


def telemetry(model, batch):
    """bench.py's cap telemetry for both agents' clouds: raises unless
    there are zero pillar and voxel drops at every level. Returns each
    cloud's levels (phase 3's shapes), by agent prefix."""
    from cmtcoop_tpu_torch.main_path import PILLAR_CAPS
    levels = {}
    for agent in ("vehicle_", "infrastructure_"):
        ext = getattr(model, agent + "model")
        stats, counts, levels[agent] = levels_of(batch, agent, ext)
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
    return levels


def gather_telemetry(model, batch):
    """The gather path's cap telemetry for both agents' clouds: raises
    unless no voxel is dropped and no downsample has more output sites than
    its stage cap."""
    from cmtcoop_tpu_torch.main_path import sparse_telemetry
    for agent in ("vehicle_", "infrastructure_"):
        t = sparse_telemetry(getattr(model, agent + "model"),
                             batch[agent + "points"][0],
                             batch[agent + "points_mask"][0])
        sites = " ".join(f"D{i + 1}={n}/{c}"
                         for i, (n, c) in enumerate(t["sites"]))
        log(f"cloud {agent} (gather): {t['n_voxels_raw']} voxels "
            f"({t['n_voxels_dropped']} dropped), output sites {sites}")
        if t["n_voxels_dropped"] or any(n > c for n, c in t["sites"]):
            raise AssertionError(f"{agent} cloud overflows a gather cap")


def gather_vs_pillar(gather, pillar, batch):
    """The float32 check at full width: the vehicle cloud through the
    gather encoder and through the pillar encoder, on the same weights."""
    ge, pe = gather.vehicle_model, pillar.vehicle_model
    ws, wp = (e.pts_middle_encoder.state_dict() for e in (ge, pe))
    if ws.keys() != wp.keys() or not all(torch.equal(ws[k], wp[k])
                                         for k in ws):
        raise AssertionError("gather and pillar encoders differ in weights")
    pts, m = batch["vehicle_points"][0], batch["vehicle_points_mask"][0]
    with torch.inference_mode():
        feats, vox = ge.voxel_features(pts, m)
        g = ge.pts_middle_encoder(feats, vox.coords, vox.mask,
                                  dtype=torch.float32)
        p = pe.pts_middle_encoder(*pe.pillarize(pts, m), dtype=torch.float32)
    peak = float(p.abs().max())
    err = float((g - p).abs().max()) / max(peak, 1e-30)
    log(f"gather vs pillar encoder (float32, full width, vehicle cloud): "
        f"BEV {tuple(g.shape)}, max |gather - pillar| / max |pillar| = "
        f"{err:.3e} (max |pillar| {peak:.3e}, tol {GATHER_TOL:g})")
    if g.shape != p.shape or not err <= GATHER_TOL:
        raise AssertionError("the gather and pillar encoders disagree")


def run_path(preset, model, batch):
    """Phase 4 on one main path: warm-up, N_FRAMES timed frames, the
    checks of the module docstring. Returns the launch counts and the
    launches per (kernel, shape) where a wrapper records its shape."""
    from cmtcoop_tpu_torch import _build, main_path
    head = model.pts_bbox_head
    finite, memory_len = [], []

    def check_finite(name):
        def hook(m, i, o):
            outs = o if isinstance(o, tuple) else (o,)
            finite.append((name, all(torch.isfinite(t).all() for t in outs)))
        return hook

    hooks = [head.transformer.decoder.register_forward_hook(
        check_finite("decoder"))]
    for a in model.agents:
        ext = getattr(model, a + "_model")
        hooks.append(ext.pts_neck.register_forward_hook(check_finite("bev")))
        if ext.use_camera:
            hooks.append(ext.img_neck.register_forward_hook(
                check_finite("cpfpn")))
    build_memory = head.build_memory

    def recording_build_memory(agent):
        mem, pos = build_memory(agent)
        memory_len.append(mem.shape[1])
        return mem, pos

    head.build_memory = recording_build_memory
    with torch.inference_mode():
        main_path.frame(model, batch)  # warm-up (first-launch costs)
        finite.clear()
        memory_len.clear()
        _build.reset_counts()
        times = []
        for _ in range(N_FRAMES):
            t0 = time.perf_counter()
            task_outs, dec = main_path.frame(model, batch)
            times.append((time.perf_counter() - t0) * 1e3)
        launches = dict(_build.launch_counts)
        shapes = dict(_build.launch_shapes)
    for h in hooks:
        h.remove()
    del head.build_memory
    bad = [name for name, ok in finite if not bool(ok)]
    # per frame and agent: the BEV map, the CPFPN outputs with the camera
    # branch, the decoder pass
    per_agent = 3 if model.vehicle_model.use_camera else 2
    if bad or len(finite) != per_agent * len(model.agents) * N_FRAMES:
        raise AssertionError(f"{preset}: non-finite outputs before "
                             f"nan_to_num: {bad}")
    for k, v in task_outs[0].items():
        if not bool(torch.isfinite(v).all()) or v.shape[:3] != (6, 1, 900):
            raise AssertionError(f"{preset}: task output {k} "
                                 f"{tuple(v.shape)}")
    if dec.scores.shape != (300,) or dec.boxes.shape != (300, 9) or not bool(
            torch.isfinite(dec.boxes).all()):
        raise AssertionError(f"{preset}: decode did not give 300 finite "
                             "slots")
    # per agent: 32400 BEV tokens, plus 4000 per 640x1600 camera view
    views = dict(zip(("vehicle", "infrastructure"), main_path.VIEWS))
    rv = 4000 if model.vehicle_model.use_camera else 0
    want = [32400 + rv * views[a] for a in model.agents] * N_FRAMES
    if memory_len != want:
        raise AssertionError(f"{preset}: memory lengths {memory_len}, "
                             f"expected {want}")
    log(f"main path {preset}: {N_FRAMES} frames, ms/frame "
        f"{' '.join(f'{t:.1f}' for t in times)} (mean "
        f"{sum(times) / len(times):.1f}), {int(dec.valid.sum())}/300 valid "
        f"slots, memory tokens per agent {memory_len[:len(model.agents)]}, "
        f"launches {launches}")
    path_kernels = main_path.PATH_KERNELS[preset]
    for name in _build.KERNELS:
        if (launches[name] > 0) != (name in path_kernels):
            raise AssertionError(f"{preset}: kernel {name} launched "
                                 f"{launches[name]} times")
    if launches["neighbor_map"] != main_path.MAP_LAUNCHES[preset] * N_FRAMES:
        raise AssertionError(f"{preset}: {launches['neighbor_map']} "
                             f"neighbour-map launches in {N_FRAMES} frames, "
                             "not one a map")
    return launches, shapes


def per_run(results, shapes, name, library, unit, path=None):
    """Kernel `name` per frame or step of one path's run (`unit`, e.g.
    "fusion_frame"): phase 3's times at each shape weighted by the launches
    the run's N_FRAMES timed frames or steps made at it (`shapes`, (kernel,
    shape) -> launches), over the cases timed for that path (a case's
    "path" equal to `path`; None takes every case). Raises unless the run
    launched at exactly those cases' shapes."""
    cases = [c for c in results[name]["cases"]
             if path is None or c.get("path") == path]
    launched = {shape: n for (k, shape), n in shapes.items() if k == name}
    timed = {tuple(c["shape"]) for c in cases}
    if (set(launched) != timed or len(timed) != len(cases)
            or any(n % N_FRAMES for n in launched.values())):
        raise AssertionError(f"{name}'s {unit} shapes {launched} are not "
                             f"the {len(timed)} shapes phase 3 timed")
    key = "launches_per_" + unit
    for c in cases:
        c[key] = launched[tuple(c["shape"])] // N_FRAMES
    sums = {k: sum(c[k] * c[key] for c in cases)
            for k in ("ms", "library_ms", "bound_ms")}
    results[name][f"per_{unit}_ms"] = sums
    log(f"kernel {name} per {unit.replace('_', ' ')} ("
        f"{sum(c[key] for c in cases)} launches at {len(cases)} shapes, "
        f"counted in the path's run): kernel {sums['ms']:.3f} ms, {library} "
        f"{sums['library_ms']:.3f} ms, bound {sums['bound_ms']:.3f} ms")


def map_per_run(results, shapes, unit, preset):
    """Kernel 9 per frame or step of one path's run (`unit`): phase 3's
    times of its encoder's maps weighted by the launches the run's N_FRAMES
    frames or steps made at each map's shape, the cases at one shape (the
    two clouds' on the pillar encoder) sharing them. Raises unless the run
    made `main_path.MAP_LAUNCHES` launches a frame, at exactly the shapes
    phase 3 timed."""
    from cmtcoop_tpu_torch.main_path import GATHER_PATH, MAP_LAUNCHES
    encoder = "gather" if preset == GATHER_PATH else "pillar"
    cases = [c for c in results["neighbor_map"]["cases"]
             if c["path"] == encoder]
    launched = {shape: n for (k, shape), n in shapes.items()
                if k == "neighbor_map"}
    per_shape = Counter(tuple(c["shape"]) for c in cases)
    if (set(launched) != set(per_shape)
            or sum(launched.values()) != MAP_LAUNCHES[preset] * N_FRAMES):
        raise AssertionError(f"neighbor_map's {unit} launches {launched} "
                             f"are not {MAP_LAUNCHES[preset]} a frame at the "
                             f"{len(per_shape)} shapes phase 3 timed")
    key = "launches_per_" + unit
    sums = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms"), 0.0)
    for c in cases:
        shape = tuple(c["shape"])
        c[key] = launched[shape] / N_FRAMES / per_shape[shape]
        for k in sums:
            sums[k] += c[k] * c[key]
    sums["launches"] = MAP_LAUNCHES[preset]
    results["neighbor_map"][f"per_{unit}_ms"] = sums
    log(f"kernel neighbor_map per {unit.replace('_', ' ')} "
        f"({sums['launches']} launches at {len(per_shape)} shapes, counted "
        f"in the path's run): kernel {sums['ms']:.4f} ms, plain "
        f"{sums['plain_ms']:.4f} ms, torch.searchsorted "
        f"{sums['library_ms']:.4f} ms, bound {sums['bound_ms']:.4f} ms")


def pillar_per_run(results, shapes, unit):
    """Kernels 1 and 2 per frame of one path's run (`unit`): phase 3's
    times at each conv shape weighted by the launches the run's N_FRAMES
    frames made at it, each agent's cloud by its half (the two agents
    launch at the same shapes, the same number of times). Raises unless
    the run launched at exactly the shapes phase 3 timed, an even number of
    times a frame."""
    key = "launches_per_" + unit
    total = dict(ms=0.0, bound_ms=0.0, launches=0)
    for name in ("pillar_conv_kb9", "pillar_conv_kb1"):
        cases = results[name]["cases"]
        launched = {shape: n for (k, shape), n in shapes.items()
                    if k == name}
        timed = {tuple(c["shape"]) for c in cases}
        if (set(launched) != timed
                or any(n % (2 * N_FRAMES) for n in launched.values())):
            raise AssertionError(f"{name}'s {unit} shapes {launched} are "
                                 f"not the {len(timed)} shapes phase 3 "
                                 "timed, each launched by both agents")
        for c in cases:
            c[key] = launched[tuple(c["shape"])] // (2 * N_FRAMES)
        sums = {k: sum(c[k] * c[key] for c in cases)
                for k in ("ms", "bound_ms", "plain_ms")}
        results[name][f"per_{unit}_ms"] = sums
        n = sum(c[key] for c in cases)
        total["ms"] += sums["ms"]
        total["bound_ms"] += sums["bound_ms"]
        total["launches"] += n
        log(f"kernel {name} per {unit.replace('_', ' ')} ({n} launches at "
            f"{len(timed)} shapes, counted in the path's run): kernel "
            f"{sums['ms']:.3f} ms, plain {sums['plain_ms']:.3f} ms, bound "
            f"{sums['bound_ms']:.3f} ms")
    log(f"kernels 1 and 2 per {unit.replace('_', ' ')}: {total['launches']} "
        f"launches, kernel {total['ms']:.3f} ms, bound "
        f"{total['bound_ms']:.3f} ms")


def slice_parity(name, model, batch, kernels, dev):
    """Phase 5 on one small detector: GPU kernels vs CPU plain, float32."""
    from cmtcoop_tpu_torch import _build
    from cmtcoop_tpu_torch.models.build import random_init_
    random_init_(model, torch.Generator().manual_seed(SEED))
    sb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        cpu_outs, _ = model(sb)
        gpu_model = copy.deepcopy(model).to(dev)
        before = dict(_build.launch_counts)
        gpu_outs, _ = gpu_model({k: v.to(dev) for k, v in sb.items()})
    used = {k: _build.launch_counts[k] - before[k] for k in before}
    worst = 0.0
    for k, ref in cpu_outs[0].items():
        got = gpu_outs[0][k].cpu()
        worst = max(worst, float((got - ref).abs().max()) /
                    max(1.0, float(ref.abs().max())))
    log(f"slice parity ({name}, float32, GPU kernels vs CPU plain): max err "
        f"{worst:.3e} of max(1, max|ref|) (tol {SLICE_TOL:g}), kernel "
        f"launches {used}")
    if worst > SLICE_TOL or {k for k, n in used.items() if n} != set(kernels):
        raise AssertionError(f"slice parity failed ({name})")


def run_train(dev):
    """Phase 5: the full-width train step, warm-up plus N_FRAMES timed
    steps, and the checks of the module docstring. Returns the launch
    counts of the timed steps, their launches per (kernel, shape) and the
    mean ms/step."""
    from cmtcoop_tpu_torch import _build, main_path
    from cmtcoop_tpu_torch.models import cmt_loss
    model, batch, opt, step = main_path.build_train_path(dev)
    with torch.no_grad():
        telemetry(model, batch)
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    params = [p.detach().clone() for p in opt.params]
    solve_s = []
    solve = cmt_loss.solve_lap

    def timed_solve(*a):
        t0 = time.perf_counter()
        out = solve(*a)
        solve_s[-1] += time.perf_counter() - t0
        return out

    cmt_loss.solve_lap = timed_solve
    try:
        solve_s.append(0.0)
        step(batch)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_counts()
        times, metrics = [], []
        for _ in range(N_FRAMES):
            solve_s.append(0.0)
            t0 = time.perf_counter()
            m = step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
        launches = dict(_build.launch_counts)
        shapes = dict(_build.launch_shapes)
    finally:
        cmt_loss.solve_lap = solve
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, m in enumerate(metrics):
        if not all(math.isfinite(x) for x in m.values()):
            raise AssertionError(f"train step {i}: non-finite metrics {m}")
    no_grad = [n for n, p in zip(opt.names, opt.params)
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    if no_grad:
        raise AssertionError(f"train: no or non-finite gradient for "
                             f"{no_grad[:5]} ({len(no_grad)} parameters)")
    still = [n for n, p, p0 in zip(opt.names, opt.params, params)
             if torch.equal(p.detach(), p0)]
    if still:
        raise AssertionError(f"train: parameters did not move: {still[:5]}")
    for n, b in model.named_buffers():
        moved = not torch.equal(b, buffers[n])
        if moved != ("img_backbone" not in n):
            raise AssertionError(f"train: running statistic {n} "
                                 f"{'moved' if moved else 'did not move'}")
    path_kernels = main_path.PATH_KERNELS[main_path.TRAIN_PATH]
    for name in _build.KERNELS:
        if (launches[name] > 0) != (name in path_kernels):
            raise AssertionError(f"train: kernel {name} launched "
                                 f"{launches[name]} times")
    if launches["neighbor_map"] != (main_path.MAP_LAUNCHES[
            main_path.TRAIN_PATH] * N_FRAMES):
        raise AssertionError(f"train: {launches['neighbor_map']} "
                             f"neighbour-map launches in {N_FRAMES} steps, "
                             "not one a map")
    solve_ms = [t * 1e3 for t in solve_s[1:]]
    log(f"train path {main_path.TRAIN_PATH}: {N_FRAMES} steps, ms/step "
        f"{' '.join(f'{t:.1f}' for t in times)} (mean "
        f"{sum(times) / len(times):.1f}), Hungarian solve on the host "
        f"{' '.join(f'{t:.1f}' for t in solve_ms)} ms/step, peak memory "
        f"{peak_gb:.2f} GiB, {len(opt.params)} parameter tensors all with "
        f"finite gradients and moved, launches {launches}")
    for i, m in enumerate(metrics):
        log(f"train step {i + 1} metrics: " + json.dumps(
            {k: round(v, 6) for k, v in m.items()}))
    return launches, shapes, sum(times) / len(times)


def train_parity(dev):
    """Phase 6, train: one step of the small fusion detector (dropout 0;
    DN noise and grid mask from the same CPU generators), float32, the
    GPU's (kernels 7 and 8) against the CPU's (plain versions): the loss
    dict and every gradient."""
    from cmtcoop_tpu_torch import _build, main_path
    from cmtcoop_tpu_torch.configs.presets import (SMALL_FUSION_EXTRACTOR,
                                                   SMALL_FUSION_HEAD,
                                                   SMALL_FUSION_PRESET,
                                                   tiny_preset)
    from cmtcoop_tpu_torch.data.synthetic import small_fusion_train_batch
    from cmtcoop_tpu_torch.models.build import build_detector, random_init_
    from cmtcoop_tpu_torch.models.cmt_loss import cmt_loss
    from cmtcoop_tpu_torch.train.train_step import step_generators
    preset = tiny_preset(**SMALL_FUSION_PRESET)

    def build():
        return build_detector(preset, train=True,
                              extractor_kwargs=SMALL_FUSION_EXTRACTOR,
                              head_kwargs=dict(SMALL_FUSION_HEAD, max_gt=4,
                                               dropout=0.0))

    cpu = build()
    random_init_(cpu, torch.Generator().manual_seed(SEED))
    gpu = build()
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(dev)
    batch = small_fusion_train_batch()
    runs = []
    for model, d in ((cpu, "cpu"), (gpu, dev)):
        tb = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        before = dict(_build.launch_counts)
        outs, dn_info = model(tb, step_generators(SEED, 0))
        losses = cmt_loss(outs, dn_info, tb["gt_boxes"], tb["gt_labels"],
                          tb["gt_mask"], preset.tasks)
        losses["loss"].backward()
        used = {k for k in before if _build.launch_counts[k] > before[k]}
        runs.append(({k: float(v.detach()) for k, v in losses.items()},
                     {n: p.grad.cpu() for n, p in model.named_parameters()},
                     used))
    (ref_l, ref_g, _), (got_l, got_g, used) = runs
    loss_err = max(abs(got_l[k] - v) / max(abs(v), 1e-6)
                   for k, v in ref_l.items())
    grad_err = max(float((got_g[n] - g).abs().max())
                   / (float(g.abs().max()) + 1e-6 / TRAIN_TOL)
                   for n, g in ref_g.items())
    log(f"train parity (small fusion coop detector, float32, GPU kernels vs "
        f"CPU plain): loss terms max rel err {loss_err:.3e}, gradients max "
        f"err {grad_err:.3e} of max|grad| + 1e-6 (tol {TRAIN_TOL:g}, "
        f"{len(ref_g)} tensors), kernels launched {sorted(used)}")
    if (loss_err > TRAIN_TOL or grad_err > TRAIN_TOL or set(ref_l) != set(
            got_l) or used != set(main_path.PATH_KERNELS[
                main_path.TRAIN_PATH])):
        raise AssertionError("train parity failed")


# phase 7: the training runtime. The resumed run's first step replays the
# first run's losses bit for bit; under PyTorch's deterministic algorithms
# its backward does too, and every loss term and gradient norm of the
# resumed steps is held to RESUME_TOL relative (printed: whether bit-equal).
# Without them the backward's scatter-adds sum in a varying order, and two
# runs drift apart by percents within two steps (PERF.md, §6)
RESUME_TOL = 1e-3
RUNTIME_STEPS = 4  # the CLI run, checkpointed at steps 2 and 4
VAL_SAMPLES = 2
VAL_SEED = 100  # the val scenes' seeds: not among the training stream's


class SyntheticValSet:
    """A val split in memory for the eval runner: `synthetic_sample(preset,
    VAL_SEED + i, with_gt=True)`; `ds[i]` the model inputs, the GT boxes as
    eval boxes (bottom-centred again), scored by the port's nusc protocol."""

    def __init__(self, preset, n):
        from cmtcoop_tpu_torch.data import formats
        from cmtcoop_tpu_torch.data.synthetic import synthetic_sample
        self.class_names = preset.class_names
        self.infos, self.samples, self.gt = [], [], {}
        for i in range(n):
            s = synthetic_sample(preset, np.random.default_rng(VAL_SEED + i))
            ts = 1000 + i
            self.infos.append({"timestamp": ts})
            m = s["gt_mask"]
            boxes = s["gt_boxes"][m].copy()
            boxes[:, 2] -= boxes[:, 5] / 2
            self.gt[ts] = formats.gt_to_eval_boxes(
                boxes, s["gt_labels"][m], self.class_names, ts)
            self.samples.append({k: v for k, v in s.items()
                                 if not k.startswith("gt_")})

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]

    def evaluate(self, preds, output_dir=None):
        from cmtcoop_tpu_torch.data.eval import nusc_protocol
        return nusc_protocol.evaluate_detection(
            self.gt, preds, self.class_names, output_dir=output_dir)


class StubDataset:
    """Picklable (index, epoch) samples for the spawned loader workers."""

    def __init__(self, n):
        self.n, self.epoch = n, 0

    def set_epoch(self, epoch):
        self.epoch = int(epoch)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"idx": np.array([i]), "epoch": np.array([self.epoch])}


def metric_rows(work_dir):
    with open(Path(work_dir) / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def rel_err(a, b):
    return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in b)


def run_runtime(dev, bare_train_ms, smi):
    """Phase 7: the training runtime on the card at full width (the module
    docstring's checks). Returns the launch counts of the CLI's training
    run and of the eval runner."""
    import itertools
    import tempfile
    from cmtcoop_tpu_torch import _build, main_path
    from cmtcoop_tpu_torch.configs.presets import get_preset
    from cmtcoop_tpu_torch.data.loader import PrefetchLoader
    from cmtcoop_tpu_torch.data.synthetic import synthetic_batch_iter
    from cmtcoop_tpu_torch.models.build import build_detector
    from cmtcoop_tpu_torch.tools import train as train_cli
    from cmtcoop_tpu_torch.train import checkpoint as ckpt
    from cmtcoop_tpu_torch.train.eval_hook import run_eval, to_device
    from cmtcoop_tpu_torch.train.trainer import Trainer
    name = main_path.FUSION_PRESET
    preset = get_preset(name)
    torch.cuda.reset_peak_memory_stats()
    out = {"card": smi, "preset": name}
    saves = []
    save = ckpt.save_checkpoint

    def timed_save(ckpt_dir, step, state, max_keep=5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save(ckpt_dir, step, state, max_keep)
        saves.append(dict(step=step, ms=(time.perf_counter() - t0) * 1e3,
                          bytes=Path(path).stat().st_size))
        return path

    def finite_rows(rows, steps, what):
        if [r["step"] for r in rows] != list(steps) or not all(
                math.isfinite(v) for r in rows for k, v in r.items()
                if k != "step"):
            raise AssertionError(f"{what}: metrics rows {rows}")

    ckpt.save_checkpoint = timed_save
    # the two training runs, the eval hook and the stale-pack check take
    # PyTorch's deterministic algorithms (the sums of `index_add_` and of
    # the gather convs' backward in a fixed order), so that the resumed run
    # can replay the first one past its first step; timings come after
    torch.use_deterministic_algorithms(True, warn_only=True)
    with tempfile.TemporaryDirectory() as tmp:
        try:
            # 7.1 the CLI, through main(argv), on the preset's own widths
            cli_dir = Path(tmp) / "cli"
            _build.reset_counts()
            t0 = time.perf_counter()
            cli = train_cli.main([
                name, "--synthetic", "--steps", str(RUNTIME_STEPS),
                "--epochs", "2", "--dtype", "bfloat16", "--seed", str(SEED),
                "--work-dir", str(cli_dir), "--log-interval", "1"])
            torch.cuda.synchronize()
            out["cli_s"] = time.perf_counter() - t0
            train_launches = dict(_build.launch_counts)
            del cli
            rows = metric_rows(cli_dir)
            finite_rows(rows, range(1, RUNTIME_STEPS + 1), "CLI run")
            steps = ckpt.all_steps(cli_dir / "ckpts")
            if steps != [2, 4]:
                raise AssertionError(f"CLI run: checkpoints at {steps}")
            kernels = main_path.PATH_KERNELS[main_path.TRAIN_PATH]
            for k in _build.KERNELS:
                if (train_launches[k] > 0) != (k in kernels):
                    raise AssertionError(f"CLI run: kernel {k} launched "
                                         f"{train_launches[k]} times")
            out["cli_ms_per_step"] = [r["sec_per_step"] * 1e3 for r in rows]
            torch.cuda.empty_cache()

            # 7.2 resume from step 2, the stream from its third batch, with
            # the eval hook at step 4 and keep-1 checkpoints every step
            val = SyntheticValSet(preset, VAL_SAMPLES)
            holder, evals = {}, []

            def eval_hook(state, step):
                if "model" not in holder:
                    holder["model"] = build_detector(
                        preset, dtype=torch.bfloat16).to(dev)
                model = holder["model"]
                model.load_state_dict(state["model"])
                _build.reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                summary, preds = run_eval(model, val, preset)
                torch.cuda.synchronize()
                evals.append(dict(step=step, preds=preds,
                                  ms=(time.perf_counter() - t0) * 1e3,
                                  launches=dict(_build.launch_counts)))
                return {"object/map": float(summary["mean_ap"]),
                        "object/nds": float(summary["nd_score"])}

            res_dir = Path(tmp) / "resumed"
            trainer = Trainer(build_detector(preset, train=True,
                                             dtype=torch.bfloat16),
                              preset.tasks, total_steps=RUNTIME_STEPS,
                              work_dir=str(res_dir), log_interval=1,
                              ckpt_interval_steps=1, max_keep_ckpts=1,
                              seed=SEED, device=dev)
            trainer.init_state()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if not trainer.resume(str(cli_dir / "ckpts"), step=2):
                raise AssertionError("resume found no checkpoint")
            torch.cuda.synchronize()
            out["restore_ms"] = (time.perf_counter() - t0) * 1e3
            if trainer.step != 2:
                raise AssertionError(f"resumed at step {trainer.step}")
            stream = synthetic_batch_iter(preset, 1, SEED)
            trainer.run(itertools.islice(stream, 2, None), eval_hook=eval_hook,
                        eval_interval_steps=RUNTIME_STEPS)
            res_rows = metric_rows(res_dir)
            finite_rows([r for r in res_rows if "eval" not in r], (3, 4),
                        "resumed run")
            ref = {r["step"]: r for r in rows}
            got = {r["step"]: r for r in res_rows if "eval" not in r}
            losses = [k for k in ref[3]
                      if k not in ("step", "sec_per_step", "grad_norm")]
            step3_equal = all(got[3][k] == ref[3][k] for k in losses)
            errs = {(s, k): abs(got[s][k] - ref[s][k]) / max(abs(ref[s][k]),
                                                             1e-12)
                    for s in (3, 4) for k in losses + ["grad_norm"]}
            worst = max(errs, key=errs.get)
            out.update(resume_step3_losses_bit_equal=step3_equal,
                       resume_steps_3_4_bit_equal=not any(errs.values()),
                       resume_max_rel_err=errs[worst],
                       resume_max_rel_err_at=list(worst))
            kept = ckpt.all_steps(res_dir / "ckpts")
            log(f"resume: step 3 losses bit-equal {step3_equal}; steps 3 and "
                f"4, every loss term and grad_norm, bit-equal "
                f"{out['resume_steps_3_4_bit_equal']}, max rel err "
                f"{errs[worst]:.3e} at step {worst[0]} {worst[1]} "
                f"({got[worst[0]][worst[1]]!r} against "
                f"{ref[worst[0]][worst[1]]!r}; tol {RESUME_TOL:g}); keep-1 "
                f"left {kept}")
            if not step3_equal or errs[worst] > RESUME_TOL:
                raise AssertionError("resume does not replay the first run")
            if kept != [RUNTIME_STEPS]:
                raise AssertionError(f"keep-1 left checkpoints {kept}")
            eval_rows = [r for r in res_rows if "eval" in r]
            out["eval_row"] = eval_rows

            # 7.3 the eval runner: the hook's run at step 4
            (first,) = evals
            ev = eval_rows[0]["eval"] if eval_rows else {}
            if not (len(eval_rows) == 1 and all(
                    math.isfinite(ev.get(k, math.nan))
                    for k in ("object/map", "object/nds"))):
                raise AssertionError(f"eval rows {eval_rows}")
            eval_kernels = main_path.PATH_KERNELS[main_path.FUSION_PRESET]
            eval_launches = first["launches"]
            for k in _build.KERNELS:
                if (eval_launches[k] > 0) != (k in eval_kernels):
                    raise AssertionError(f"eval runner: kernel {k} launched "
                                         f"{eval_launches[k]} times")
            if not all(first["preds"].values()):
                raise AssertionError("eval runner: a sample with no box")
            # stale packs: another train step, the held eval model reloaded,
            # against a fresh eval model loaded from the same state_dict
            batch = to_device(next(synthetic_batch_iter(preset, 1, SEED)), dev)
            trainer.step_fn(batch)
            held = holder["model"]
            sd = trainer.model.state_dict()
            timed = {}
            fresh = build_detector(preset, dtype=torch.bfloat16).to(dev)
            for what, model in (("reloaded", held), ("fresh", fresh)):
                model.load_state_dict(sd)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                timed[what] = run_eval(model, val, preset)[1]
                torch.cuda.synchronize()
                out[f"eval_ms_per_sample_{what}"] = (
                    (time.perf_counter() - t0) * 1e3 / len(val))
            out["eval_ms_per_sample_hook"] = first["ms"] / len(val)
            stale_ok = timed["reloaded"] == timed["fresh"]
            moved = timed["fresh"] != first["preds"]
            log(f"eval runner: step-4 map {ev['object/map']:.4f} nds "
                f"{ev['object/nds']:.4f} over {len(val)} samples; after "
                f"another step the reloaded eval model equals a fresh one: "
                f"{stale_ok} (its boxes moved: {moved}); launches "
                f"{eval_launches}")
            if not (stale_ok and moved):
                raise AssertionError("stale-pack check failed")
            del holder, held

            # timings in PyTorch's default (nondeterministic) mode: eval
            # with the packs held, the Trainer against the bare step on the
            # same synthetic batches
            torch.use_deterministic_algorithms(False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_eval(fresh, val, preset)
            torch.cuda.synchronize()
            out["eval_ms_per_sample_steady"] = (
                (time.perf_counter() - t0) * 1e3 / len(val))
            del fresh
            trainer.total_steps = trainer.step + 3
            trainer.ckpt_interval_steps = None
            trainer.run(itertools.islice(stream, 3))
            tail = metric_rows(res_dir)[-3:]
            out["trainer_ms_per_step"] = [r["sec_per_step"] * 1e3
                                          for r in tail]
            bare = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = trainer.step_fn(batch)
                float(m["loss"])
                bare.append((time.perf_counter() - t0) * 1e3)
            out["bare_step_ms_same_batch"] = bare
            trainer.close()
            del trainer, batch
        finally:
            ckpt.save_checkpoint = save
            torch.use_deterministic_algorithms(False)
    out["saves"] = saves
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["phase5_bare_ms_per_step"] = bare_train_ms
    torch.cuda.empty_cache()

    # 7.4 spawned loader workers after CUDA init against threads
    kw = dict(batch_size=2, num_workers=2, shuffle_seed=SEED)
    streams = []
    for procs in (False, True):
        it = PrefetchLoader(StubDataset(12), np.arange(12),
                            use_processes=procs, **kw).iter_steps(3)
        streams.append([(b["idx"].tolist(), b["epoch"].tolist())
                        for b in itertools.islice(it, 5)])
        it.close()
    out["spawn_loader_equals_threads"] = streams[0] == streams[1]
    if streams[0] != streams[1]:
        raise AssertionError(f"spawned loader {streams[1]} != threads "
                             f"{streams[0]}")
    log(f"runtime phase: saves {saves}, restore {out['restore_ms']:.1f} ms, "
        f"Trainer ms/step {out['trainer_ms_per_step']} against the bare step "
        f"{[round(t, 1) for t in bare]} ms on the same batch (phase 5's "
        f"benchmark batch {bare_train_ms:.1f}), eval ms/sample "
        f"{out['eval_ms_per_sample_steady']:.1f} (hook's first "
        f"{out['eval_ms_per_sample_hook']:.1f}), peak "
        f"{out['peak_gib']:.2f} GiB, spawned loader after CUDA init equals "
        f"threads; {smi}")
    print(json.dumps({"runtime": out}), flush=True)
    return train_launches, eval_launches


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
        SMALL_COOP_EXTRACTOR, SMALL_COOP_HEAD, SMALL_COOP_PRESET,
        SMALL_FUSION_EXTRACTOR, SMALL_FUSION_HEAD, SMALL_FUSION_PRESET,
        SMALL_GATHER_EXTRACTOR, tiny_preset)
    from cmtcoop_tpu_torch.data.synthetic import (small_coop_batch,
                                                  small_fusion_batch)
    from cmtcoop_tpu_torch.models.build import build_detector

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

    # the LiDAR path's model and batch, with its clouds' telemetry (zero
    # drops), which also gives phase 3 its pillar shapes
    model, batch = main_path.build_main_path(dev, main_path.PRESET)
    with torch.inference_mode():
        levels = telemetry(model, batch)

    # 3. each kernel against its plain version
    results = {}
    with torch.inference_mode():
        pillar_kernel_phases(levels, results, dev)
        kernel_phases(results, dev)
        neighbor_map_phases(model, batch, results)
        rows_copy_phases(dev, results)
    train_kernel_phases(results, dev)

    # 4. the main paths, one or two models on the card at a time
    launches, shapes = {}, {}
    launches[main_path.PRESET], shapes["lidar"] = run_path(main_path.PRESET,
                                                           model, batch)
    per_run(results, shapes["lidar"], "flash_attention_packed", "SDPA",
            "lidar_frame", "lidar")
    pillar_per_run(results, shapes["lidar"], "lidar_frame")
    map_per_run(results, shapes["lidar"], "lidar_frame", main_path.PRESET)
    del levels
    path = main_path.GATHER_PATH
    gather, gather_batch = main_path.build_main_path(dev, path)
    with torch.inference_mode():
        gather_telemetry(gather, gather_batch)
    launches[path], shapes["gather"] = run_path(path, gather, gather_batch)
    map_per_run(results, shapes["gather"], "gather_frame", path)
    gather_vs_pillar(gather, model, batch)
    del model, batch, gather, gather_batch
    torch.cuda.empty_cache()
    preset = main_path.FUSION_PRESET
    model, batch = main_path.build_main_path(dev, preset)
    with torch.inference_mode():
        telemetry(model, batch)
    launches[preset], fusion = run_path(preset, model, batch)
    per_run(results, fusion, "conv3x3_bn_relu", "cuDNN", "fusion_frame")
    per_run(results, fusion, "osa_aggregate", "cat + bf16 matmul",
            "fusion_frame")
    per_run(results, fusion, "flash_attention_packed", "SDPA",
            "fusion_frame", "fusion")
    pillar_per_run(results, fusion, "fusion_frame")
    map_per_run(results, fusion, "fusion_frame", preset)
    del model, batch
    torch.cuda.empty_cache()

    # 5. the train path
    launches[main_path.TRAIN_PATH], train, train_ms = run_train(dev)
    per_run(results, train, "flash_train_fwd", "SDPA", "train_step",
            "train")
    for name in ("flash_train_bwd_dq", "flash_train_bwd_dkv"):
        per_run(results, train, name, "SDPA backward (dq, dk, dv)",
                "train_step", "train")
    map_per_run(results, train, "train_step", main_path.TRAIN_PATH)
    torch.cuda.empty_cache()

    # 6. slice parity (small configs): GPU kernels vs CPU plain, float32
    slice_parity("small LiDAR coop detector",
                 build_detector(tiny_preset(**SMALL_COOP_PRESET),
                                extractor_kwargs=SMALL_COOP_EXTRACTOR,
                                head_kwargs=SMALL_COOP_HEAD),
                 small_coop_batch(), main_path.PATH_KERNELS[main_path.PRESET],
                 dev)
    slice_parity("small gather coop detector",
                 build_detector(tiny_preset(**SMALL_COOP_PRESET),
                                extractor_kwargs=SMALL_GATHER_EXTRACTOR,
                                head_kwargs=SMALL_COOP_HEAD),
                 small_coop_batch(),
                 main_path.PATH_KERNELS[main_path.GATHER_PATH], dev)
    slice_parity("small fusion coop detector",
                 build_detector(tiny_preset(**SMALL_FUSION_PRESET),
                                extractor_kwargs=SMALL_FUSION_EXTRACTOR,
                                head_kwargs=SMALL_FUSION_HEAD),
                 small_fusion_batch(),
                 main_path.PATH_KERNELS[main_path.FUSION_PRESET], dev)
    train_parity(dev)
    torch.cuda.empty_cache()

    # 7. the training runtime: the CLI, resume, the eval runner, the loader
    launches["trainer"], launches["eval runner"] = run_runtime(dev, train_ms,
                                                               smi)

    kernels = []
    for name in _build.KERNELS:
        src, replaces = SOURCES[name]
        r = results[name]
        per_path = {p: n[name] for p, n in launches.items()}
        kernels.append(dict(name=name, route="cuda", impl=IMPLS[name],
                            source=src, replaces=replaces,
                            launches=sum(per_path.values()),
                            launches_per_path=per_path,
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"],
                            cases=r["cases"],
                            **{k: v for k, v in r.items()
                               if k.startswith("per_")
                               or k in ("host_us_per_launch", "bound_ops")}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
