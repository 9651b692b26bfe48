#!/usr/bin/env python3
"""Correctness check of the PyTorch / CUDA port (cmtcoop_tpu_torch) on one
GPU. It measures nothing: time on the card is the benchmark's (`python3 -m
bench_torch.run`).

Run from the root of a checkout, on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):
  1. the device: its name and `nvidia-smi` name / power limit;
  2. the kernel build (nvcc, sm_90a);
  3. the hand-written kernels whose inputs come from the LiDAR path's
     encoders or from no path, each against its plain PyTorch version on
     the card: kernels 1 and 2 at every conv of the pillar encoder on each
     agent's cloud, the 13 of `PILLAR_CONVS` x 2, with the neighbour maps
     and occupancy of the benchmark clouds, through the wrapper the eval
     encoder calls, weights packed once and rows compacted once per level,
     two bf16 calls bit-equal, each down conv's folded occupancy
     (`cmt_pillar_occ_fold`) equal to `occ_downsample`'s; the fused
     neighbour map (kernel 9) at every map of the pillar encoder on both
     clouds (7 + 7) and of the gather encoder on the vehicle cloud (8, the
     stage-0 submanifold map the largest), each map's inputs captured from
     the encoder, bit-equal, with its tiles' bracket widths (p50, p99, max),
     and each encoder's map builders run once under
     `torch.cuda.set_sync_debug_mode("error")`; kernel 5, on no path, at
     V3 80x200 160->160 with a residual; and the row copy (kernel 10), on no
     path, at (40960, 768) in bfloat16 and float32, bit-equal to `clone()`;
  4. the eval main paths, each through `build_detector` at full width in
     bfloat16 with seeded random weights: `cmt_lidar_coop_tumtraf`, the
     same with the gather sparse encoder (main_path.py `GATHER_PATH`), then
     the flagship `cmt_fusion_coop_tumtraf` (plus 1 vehicle and 3
     infrastructure cameras at 640x1600), on the benchmark batch (two
     65536-point ray-cast clouds, seed 0); then the single-agent nuScenes
     detector `cmt_fusion_nuscenes` (six 640x1600 views, six task groups,
     its own caps; main_path.py `NUSC_PATH`) on a 300000-row ten-sweep
     cloud (main_path.py `single_batch`), whose pillar convs (kernels 1 and
     2) and neighbour maps (kernel 9) are first checked on that cloud as
     phase 3 checks the coop clouds'; then its real-time variant
     `cmt_fusion_r50_nuscenes` (ResNet-50 on six 320x800 views, 0.1-m
     voxels on a 1024 x 1024 grid; main_path.py `R50_PATH`) on the same
     cloud, its kernels 1, 2 and 9 checked on its own grid first. Per
     path: zero pillar and voxel cap drops at every level (on the gather path zero voxel drops and no
     downsample with more output sites than its stage cap); an eager frame
     of forward and top-300 decode, whose BEV maps (and CPFPN outputs) and
     decoder outputs must be finite; the frame that captures the path's
     CUDA graphs; and a replayed frame (eager on the gather path), its
     launches counted from zero: the memory token counts (a BEV token a
     cell of the grid over the head's downsample scale, 32400 at 1440^2,
     plus a token a stride-16 cell of each view, 4000 at 640x1600), the
     launch count of every kernel of the path above zero and of every
     other kernel zero, kernel 9 one launch a map; the capture and
     replay frames each held to the eager frame. The shapes the replayed frame launched each kernel at are
     printed; kernels 3, 4 and 6 are then checked, in bfloat16 and
     float32, at every one of them that no earlier path launched, and every
     shape the path launched kernels 1, 2 and 9 at must be one already
     checked. Between the gather and the fusion paths, a float32 check at
     full width: the gather encoder against the pillar encoder on the same
     weights and the vehicle cloud (they compute the same function), max
     |gather - pillar| / max |pillar| of the BEV maps within GATHER_TOL;
  5. the train path: the full-width `cmt_fusion_coop_tumtraf` train step
     (main_path.py `build_train_path`: DN with 128 GT slots, dropout 0.1,
     grid mask, Hungarian loss, backward, clipped AdamW, bfloat16), 2 steps
     with their launches counted: finite losses and gradient norms, a
     gradient for every parameter, VoVNet's running statistics unchanged
     and SECOND's and the pillar encoder's moved, every parameter moved,
     zero cap drops, kernels 7 and 8 launched and kernels 1 to 6 not; then
     kernels 7 and 8 in bfloat16 and float32 at every shape the steps
     launched them at, at the decoder's dropout, and at dropout 0 at the
     largest: kernel 7's out, m and l and kernel 8's dq and d(k_bias)
     bit-equal across two calls, and with dropout kernel 7's (out, m, l)
     through kernel 8 against the plain forward and backward;
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
     state_dict, bit for bit (its packed operands follow the weights); a
     spawned `PrefetchLoader` after CUDA init yields the thread mode's
     stream. It prints the resume's errors, the eval rows and the card's
     name and power limit as one `{"runtime": ...}` JSON line;
  8. the on-disk slice, on `cmt_fusion_coop_tumtraf` at its own widths and
     caps (bfloat16): a raw TUMTraf-layout archive from the port's
     `build_raw_archive` (train 6 frames, seed 0; val 3, seed 1; cameras
     at the TUMTraf Basler cameras' 1200x1920, stored as `.npy`) in a
     temporary directory; `create_data a9coop_nusc` on it (`main(argv)`):
     6 and 3 infos, every cloud a finite 5-column `.bin`, a GT database
     with at least one object; the native geometry library loaded;
     `build_train_loader` at batch 1 with min(4, cores) workers, in thread
     and in spawn mode, over its first epoch: the two modes' batches
     bit-equal; the train CLI on `--data-root` (no `--synthetic`): 4 steps,
     2 loader workers, the eval hook at step 4 over 2 val samples: finite
     losses, one eval record with finite `object/map` and `object/nds`, a
     checkpoint at step 4, kernels 7, 8 and 9 launched by the steps and 1,
     2, 3, 4, 6 and 9 by the hook (and no other); the test CLI on that
     checkpoint over val at batch 2 (one full batch and a padded tail):
     `metrics_summary.json` with a finite `mean_ap`, `results_nusc.json`,
     the fusion path's kernels launched. It prints whether PIL and
     torchvision import, the losses and scores, and the card's name and
     power limit as one `{"disk": ...}` JSON line.

Before the last line come a JSON object with one entry per kernel (its
launches on each main path, on phase 7's Trainer and eval runner and on
phase 8's create_data and loaders, train CLI, eval hook and test CLI, its
worst bfloat16 error, and `cases`: the note, error and shape of every bf16
case) and the card's name and power limit from `nvidia-smi`; the last line
is `{"ok": true, "device": {...}}`. Without a CUDA device, or run outside
a checkout, it exits non-zero and prints no result.
"""
import copy
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
SEED = 0
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
# the kernels checked at the shapes an eval path launched them at (the
# others of a path take their inputs from its encoders in phase 3)
PATH_CHECKED = ("flash_attention_packed", "conv3x3_bn_relu", "osa_aggregate")
TRAIN_CHECKED = ("flash_train_fwd", "flash_train_bwd_dq",
                 "flash_train_bwd_dkv")

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


def compare(name, shape_note, kernel, plain, make_inputs, results,
            exact_side=True, info=None):
    """Kernel vs plain version on the same inputs, in bfloat16 and float32;
    `make_inputs(dtype)` gives (args, kwargs). The first output is held to
    TOL of its max|plain|; side outputs are held equal (occupancy) or, with
    `exact_side=False`, each to TOL of its own max|plain|. Each bf16 case
    appends its note and error (`info` merged in) to the kernel's
    `cases`."""
    for dtype in (torch.bfloat16, torch.float32):
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
        side = "".join(f", output {i}: max_rel_err={e / max(p, 1e-30):.3e}"
                       for i, (e, p) in enumerate(errs) if i)
        log(f"kernel {name} [{shape_note}] {dname}: max_abs_err={err:.3e} "
            f"max_rel_err={err / max(peak, 1e-30):.3e} (max|plain|="
            f"{peak:.3e}, tol {TOL[dname]:g} of max|plain|){side} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {shape_note} {dname} disagrees")
        if dtype == torch.bfloat16:
            record(results, name, dict(note=shape_note, max_abs_err=err,
                                       **(info or {})))


def record(results, name, case):
    """Adds one bf16 case to a kernel's record, keeping the worst error
    over its cases."""
    rec = results.setdefault(name, dict(max_abs_err=0.0, cases=[]))
    rec["max_abs_err"] = max(rec["max_abs_err"], case["max_abs_err"])
    rec["cases"].append(case)


def checked_shapes(results):
    """{(kernel, shape)} of every case checked so far."""
    return {(name, tuple(c["shape"])) for name, r in results.items()
            for c in r["cases"]}


def extractors(model):
    """(batch key prefix, feature extractor, label) of each of `model`'s
    clouds: a cooperative detector's agents, or the single-agent detector
    itself ("single")."""
    if not hasattr(model, "agents"):
        return [("", model, "single")]
    return [(a + "_", getattr(model, a + "_model"), a) for a in model.agents]


def levels_of(batch, prefix, ext):
    """Pillars and every level's grid, occupancy and maps for one cloud."""
    from cmtcoop_tpu_torch.ops import pillars as pu
    pc, pm, occ, feats, stats = ext.pillarize(
        batch[prefix + "points"][0], batch[prefix + "points_mask"][0],
        return_stats=True)
    enc = ext.pts_middle_encoder
    d, h, w = enc.sparse_shape
    grid = pu.PillarGrid(pc, pm, (h, w), d)
    levels = [dict(grid=grid, occ=occ, nbr=pu.pillar_neighbor_map(grid))]
    counts = []
    for i, cap in enumerate(ext.pillar_caps[1:]):
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


# the pillar encoder's convs of one agent, as phase 3 checks them: (what,
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
    """Kernels 1 and 2 at every conv of the pillar encoder
    (`PILLAR_CONVS`) on each cloud of `clouds` (label -> levels), through
    the wrapper the eval encoder calls: the weights packed once
    (`pack_pillar_weight`), the active rows compacted once per level.
    Random features on the occupied input voxels and weights from SEED;
    each bf16 case also two calls bit-equal, and each down conv's
    occupancy folded by `cmt_pillar_occ_fold` equal to
    `occ_downsample`'s."""
    from cmtcoop_tpu_torch.ops import pillars as pu
    from cmtcoop_tpu_torch.ops.pillar_fused import (
        active_rows, fold_occupancy, fused_pillar_conv_packed,
        fused_pillar_conv_reference, pack_pillar_weight)
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

            p_out, z_out = occ_out.shape
            shape = [kb, *occ_in.shape, cin, p_out, z_out, cout,
                     kind == "resid"]
            name = "pillar_conv_kb9" if kb == 9 else "pillar_conv_kb1"
            note = (f"{agent} {what} P{occ_in.shape[0]} "
                    f"Z{occ_in.shape[1]} -> P{p_out} Z{z_out} {cin}->{cout}")
            compare(name, note, fused_pillar_conv_packed, plain, inputs,
                    results, info=dict(shape=shape, agent=agent, conv=what))
            case = results[name]["cases"][-1]
            args, a = inputs(torch.bfloat16)
            first = fused_pillar_conv_packed(*args, **a)
            second = fused_pillar_conv_packed(*args, **a)
            if not torch.equal(first, second):
                raise AssertionError(f"{name} {note}: two bf16 calls differ")
            case["bit_equal"] = True
            if kind == "down":
                case["occ_fold_equal"] = True
            log(f"kernel {name} [{note}] bfloat16: two calls bit-equal"
                + ("; folded occupancy equal" if kind == "down" else ""))


def path_kernel_phases(results, shapes, path, dev):
    """Kernels 3, 4 and 6 at every shape `path`'s replayed frame launched
    them at (`shapes`: (kernel, shape) -> launches) that no earlier check
    took, in launch order, in bfloat16 and float32. Kernel 3 (Nq, Nk,
    heads, Dh): q scaled so the softmax peaks (logit std 4), a quarter of
    the keys masked with NEG_INF as padded keys are, two calls bit-equal.
    Kernel 4 (N, H, W, Cin, Cout) on operands packed once,
    as the eval modules hold them; the plain version takes the pack's
    source weight and folded BN. Kernel 6 (V, H, W, the parts' channels,
    Cout) through the packed wrapper likewise."""
    from cmtcoop_tpu_torch.ops.attention import (
        NEG_INF, flash_attention_packed, flash_attention_packed_reference)
    from cmtcoop_tpu_torch.ops.conv_cf import (osa_aggregate_packed,
                                               osa_aggregate_reference,
                                               pack_osa_weight)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    done = checked_shapes(results)
    new = [(name, shape) for name, shape in shapes
           if name in PATH_CHECKED and (name, shape) not in done]
    for name, shape in new:
        info = dict(shape=list(shape), path=path)
        if name == "flash_attention_packed":
            nq, nk, h, dh = shape
            q, k, v = (randn(1, n, h * dh, scale=s)
                       for n, s in ((nq, 4.0), (nk, 1.0), (nk, 1.0)))
            masked = torch.rand(1, nk, generator=gen, device=dev) < 0.25
            kbias = torch.where(masked, NEG_INF, 0.0)
            note = f"{path} q{nq} k{nk} {h}x{dh}, 1/4 keys masked"
            compare(name, note, flash_attention_packed,
                    flash_attention_packed_reference,
                    lambda dt: ((q.to(dt), k.to(dt), v.to(dt), kbias, h),
                                {}),
                    results, info=info)
            qb, kb16, vb = (x.to(torch.bfloat16) for x in (q, k, v))
            once = flash_attention_packed(qb, kb16, vb, kbias, h)
            if not torch.equal(once, flash_attention_packed(qb, kb16, vb,
                                                            kbias, h)):
                raise AssertionError(f"{name} {note}: two calls differ")
            log(f"kernel {name} [{note}] bfloat16: two calls bit-equal")
            del q, k, v, qb, kb16, vb, once
        elif name == "conv3x3_bn_relu":
            n, h, w, cin, cout = shape
            conv_case(name, f"{path} V{n} {h}x{w} {cin}->{cout}", randn,
                      results, n, h, w, cin, cout, False, info)
        else:
            v, h, w, *chans, cout = shape
            parts = [randn(v, h, w, c) for c in chans]
            wt = randn(sum(chans), cout, scale=sum(chans) ** -0.5)
            s, b = 1.0 + 0.1 * randn(cout), 0.1 * randn(cout)
            compare(name, f"{path} V{v} {h}x{w} {'+'.join(map(str, chans))}"
                    f"->{cout} (agg; output 1 = gap)", osa_aggregate_packed,
                    lambda parts_, packed: osa_aggregate_reference(
                        parts_, packed.source, packed.scale, packed.bias),
                    lambda dt: (([p.to(dt) for p in parts],
                                 pack_osa_weight(wt, s, b, chans, dt)), {}),
                    results, exact_side=False, info=info)


def conv_case(name, note, randn, results, v, h, w, cin, cout, with_resid,
              info):
    """Kernel 4 (or 5, `with_resid`) at one shape, in bfloat16 and float32,
    as the main path calls it: on operands packed once
    (`conv3x3_bn_relu_packed`)."""
    from cmtcoop_tpu_torch.ops.conv_cf import (conv3x3_bn_relu_packed,
                                               conv3x3_bn_relu_reference,
                                               pack_conv3x3_weight)
    x = randn(v, h, w, cin)
    wt = randn(cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
    s, b = 1.0 + 0.1 * randn(cout), 0.1 * randn(cout)
    res = randn(v, h, w, cout) if with_resid else None

    def inputs(dt):
        kw = {} if res is None else dict(residual=res.to(dt))
        return (x.to(dt), pack_conv3x3_weight(wt, s, b, dt)), kw

    compare(name, note, conv3x3_bn_relu_packed,
            lambda x_, packed, residual=None: conv3x3_bn_relu_reference(
                x_, packed.source, packed.scale, packed.bias,
                residual=residual),
            inputs, results, info=info)


def train_kernel_phases(results, shapes, rate, dev):
    """Kernels 7 and 8 against their plain versions at every shape the
    train steps launched them at (`shapes`, in launch order) at the
    decoder's dropout `rate` and at dropout 0 at the one with the most
    keys, each in bfloat16 and float32, so that the dropout's own arithmetic is
    checked apart; the backward takes the plain forward's (out, m, l), and
    its dq and d(k_bias) must be bit-equal across two calls."""
    from cmtcoop_tpu_torch import main_path
    from cmtcoop_tpu_torch.ops import attention as ta
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    seed = SEED + 7
    launched = list(dict.fromkeys(s for k, s in shapes if k in TRAIN_CHECKED))
    cases = [(s, rate) for s in launched] + [
        (max(launched, key=lambda s: s[1]), 0.0)]
    for i, ((nq, nk, h, dh), r) in enumerate(cases):
        def views(dt, *xs, h=h, dh=dh):
            return [x.to(dt).view(1, -1, h, dh).transpose(1, 2) for x in xs]

        q, k, v, dout = (
            torch.randn(1, n, h * dh, generator=gen, device=dev) * s
            for n, s in ((nq, 4.0), (nk, 1.0), (nk, 1.0), (nq, 1.0)))
        masked = torch.rand(1, nk, generator=gen, device=dev) < 0.25
        kb = torch.where(masked, ta.NEG_INF, 0.0)
        note = f"q{nq} k{nk} {h}x{dh}, 1/4 keys masked, dropout {r:g}"
        info = dict(shape=[nq, nk, h, dh], rate=r,
                    path=main_path.TRAIN_PATH if i < len(launched) else None)
        compare("flash_train_fwd", note + " (outputs 1, 2 = m, l)",
                ta.flash_attention_kvmask,
                ta.flash_attention_kvmask_reference,
                lambda dt, r=r: ((*views(dt, q, k, v), kb, True, r, seed),
                                 {}),
                results, exact_side=False, info=info)
        train_forward_checks(ta, results, note, (*views(torch.bfloat16, q,
                                                        k, v), kb),
                             views(torch.bfloat16, dout)[0], r, seed)

        prepared = {}

        def bwd_inputs(dt, r=r):
            """The backward's inputs; kernel 8's argument block (and delta)
            is built from them once, and each launch runs on it."""
            qv, kv, vv = views(dt, q, k, v)
            out, m, l = ta.flash_attention_kvmask_reference(qv, kv, vv, kb,
                                                            True, r, seed)
            args = (qv, kv, vv, kb, out, m, l, views(dt, dout)[0], r, seed)
            prepared["block"] = ta._bwd_args(*args)
            return args, {}

        compare("flash_train_bwd_dq", note,
                lambda q_, *a: ta._bwd_dq(prepared["block"][0], q_),
                lambda *a: ta.flash_attention_bwd_reference(*a)[0],
                bwd_inputs, results, exact_side=False, info=info)
        compare("flash_train_bwd_dkv", note + " (outputs dk, dv, dk_bias)",
                lambda q_, k_, v_, kb_, *a: ta._bwd_dkv(prepared["block"][0],
                                                        k_, kb_),
                lambda *a: ta.flash_attention_bwd_reference(*a)[1:],
                bwd_inputs, results, exact_side=False, info=info)
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
    """Kernel 7's bf16 route beyond `compare`: out, m and l bit-equal
    across two calls; and, with dropout, its (out, m, l) fed to kernel 8
    against the plain forward and backward (dq, dk, dv and d(k_bias), each
    within TOL of its max |plain|)."""
    case = results["flash_train_fwd"]["cases"][-1]
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


def compare_exact(name, note, kernel, plain, args, results, info):
    """A kernel whose outputs must be bit-equal to its plain version's on
    `args`; records the case with `info`."""
    got = kernel(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for i, (g, r) in enumerate(zip(got, ref)):
        if g.dtype != r.dtype or not torch.equal(g, r):
            raise AssertionError(f"{name} {note}: output {i} differs from "
                                 "the plain version")
    log(f"kernel {name} [{note}]: bit-equal to the plain version")
    record(results, name, dict(note=note, max_abs_err=0.0, **info))


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
    from cmtcoop_tpu_torch.ops import pillars as pu
    d, h, w = enc.sparse_shape
    grid = pu.PillarGrid(pcoords, pmask, (h, w), d)
    keys = grid.linear_ids
    maps = [pu.pillar_neighbor_map(grid, keys=keys)]
    for cap in enc.pillar_caps[1:]:
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


def pillar_map_calls(model, batch):
    """The arguments of every `neighbor_map` the pillar encoder makes on
    each of `model`'s clouds (7 a cloud: a subm map a level and a down map
    between levels), captured from the encoder as its path calls it; the
    map builders also run once on the first cloud under
    `set_sync_debug_mode("error")`. Returns (encoder, label, arguments)
    of each map."""
    from cmtcoop_tpu_torch.ops import pillars as pu
    calls = []
    for i, (prefix, ext, label) in enumerate(extractors(model)):
        enc = ext.pts_middle_encoder
        pillars = ext.pillarize(batch[prefix + "points"][0],
                                batch[prefix + "points_mask"][0])
        seen = captured_maps(pu, enc, *pillars, dtype=torch.bfloat16)
        want = 2 * len(enc.encoder_channels) - 1
        if len(seen) != want:
            raise AssertionError(f"{label} pillar encoder built {len(seen)} "
                                 f"neighbour maps, not {want}")
        calls += [("pillar", label, a) for a in seen]
        if i == 0:
            no_sync(f"pillar encoder map builders ({label} cloud)",
                    pillar_maps, enc, *pillars[:2])
    return calls


def gather_map_calls(model, batch):
    """The arguments of the 8 `neighbor_map`s the gather encoder makes on
    the vehicle cloud (a subm map a stage, a down map after each but the
    last, conv_out's), captured as `pillar_map_calls`'s, its map builders
    run once under `set_sync_debug_mode("error")`."""
    from cmtcoop_tpu_torch.main_path import SPARSE_CAPS
    from cmtcoop_tpu_torch.models.sparse_encoder import SparseEncoder
    from cmtcoop_tpu_torch.ops import sparse_utils as su
    ext = model.vehicle_model
    vox = ext.voxelize(batch["vehicle_points"][0],
                       batch["vehicle_points_mask"][0])
    genc = SparseEncoder(sparse_shape=ext.pts_middle_encoder.sparse_shape,
                         stage_caps=SPARSE_CAPS)
    seen = captured_maps(su, genc.maps, vox.coords, vox.mask)
    if len(seen) != 2 * len(genc.encoder_channels):
        raise AssertionError(f"gather encoder built {len(seen)} neighbour "
                             "maps, not two a stage")
    no_sync("gather encoder map builders (vehicle cloud, SparseEncoder."
            "maps)", genc.maps, vox.coords, vox.mask)
    return [("gather", "vehicle", a) for a in seen]


def neighbor_map_phases(calls, results):
    """Kernel 9 at each captured map of `calls`: bit-equal to the plain
    version, with the bracket widths of its tiles' runs
    (`neighbor_map_walk`)."""
    from cmtcoop_tpu_torch.ops import lookup_kernel as lk
    for enc_name, agent, args in calls:
        keys, coords, mask, shape, ks, st, pad = args
        _, widths = lk.neighbor_map_walk(*args)
        w = widths.float()
        brackets = (dict(p50=float(w.quantile(0.5)),
                         p99=float(w.quantile(0.99)), max=float(w.max()),
                         tile_runs=int(w.numel()))
                    if w.numel() else dict(p50=0.0, p99=0.0, max=0.0,
                                           tile_runs=0))
        _, ks, st, _ = lk.geometry(shape, ks, st, pad)
        note = (f"{enc_name} {agent} {ks} stride {st}: "
                f"{keys.shape[0]} keys, {coords.shape[0]} sites x "
                f"{math.prod(ks)} taps")
        shape_key = (keys.shape[0], coords.shape[0]) + ks + st
        compare_exact("neighbor_map", note, lk.neighbor_map,
                      lk.neighbor_map_reference, args, results,
                      dict(path=enc_name, agent=agent, shape=shape_key,
                           brackets=brackets))
        log(f"kernel neighbor_map [{note}]: bracket widths p50 "
            f"{brackets['p50']:.0f}, p99 {brackets['p99']:.0f}, max "
            f"{brackets['max']:.0f} keys over {brackets['tile_runs']} runs "
            "of a 128-site tile")


def off_path_phases(results, dev):
    """The kernels on no path: kernel 5 at V3 80x200 160->160 with a
    residual (a VoVNet stage-3 shape), in bfloat16 and float32; kernel 10
    at the packed rows of the JAX fallback branch, (40960, 768), in
    bfloat16 and float32, bit-equal to its plain version, `clone()`."""
    from cmtcoop_tpu_torch.ops.pillar_fused import (pin_rows,
                                                    pin_rows_reference)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    conv_case("conv3x3_bn_relu_resid", "V3 80x200 160->160 + residual",
              randn, results, 3, 80, 200, 160, 160, True,
              dict(shape=[3, 80, 200, 160, 160]))
    x = randn(40960, 768)
    for dt in (torch.bfloat16, torch.float32):
        xd = x.to(dt)
        compare_exact("rows_copy", f"(40960, 768) {str(dt).split('.')[-1]}",
                      pin_rows, pin_rows_reference, (xd,), results,
                      dict(shape=list(xd.shape)))


def telemetry(model, batch):
    """bench.py's cap telemetry for each of `model`'s clouds: raises unless
    there are zero pillar and voxel drops at every level. Returns each
    cloud's levels (the pillar convs' shapes), by label."""
    levels = {}
    for prefix, ext, label in extractors(model):
        stats, counts, levels[label] = levels_of(batch, prefix, ext)
        s = {k: int(v) for k, v in stats.items()}
        caps = ext.pillar_caps
        occs = " ".join(f"L{i + 1}={n}/{c}" for i, (n, c) in
                        enumerate(zip(counts, caps[1:])))
        log(f"cloud {label}: {s['n_points_in_range']} pts, "
            f"{s['n_pillars_raw']}/{caps[0]} pillars "
            f"({s['n_pillars_dropped']} dropped), {s['n_voxels_raw']} "
            f"voxels ({s['n_voxels_dropped']} dropped), {occs}")
        if s["n_pillars_dropped"] or s["n_voxels_dropped"]:
            raise AssertionError(f"{label} cloud overflows a cap")
        for n, c in zip(counts, caps[1:]):
            if n > c:
                raise AssertionError(f"{label} level occupancy {n} > {c}")
    return levels


def gather_telemetry(model, batch):
    """The gather path's cap telemetry for each of `model`'s clouds: raises
    unless no voxel is dropped and no downsample has more output sites than
    its stage cap."""
    from cmtcoop_tpu_torch.main_path import sparse_telemetry
    for prefix, ext, label in extractors(model):
        t = sparse_telemetry(ext, batch[prefix + "points"][0],
                             batch[prefix + "points_mask"][0])
        sites = " ".join(f"D{i + 1}={n}/{c}"
                         for i, (n, c) in enumerate(t["sites"]))
        log(f"cloud {label} (gather): {t['n_voxels_raw']} voxels "
            f"({t['n_voxels_dropped']} dropped), output sites {sites}")
        if t["n_voxels_dropped"] or any(n > c for n, c in t["sites"]):
            raise AssertionError(f"{label} cloud overflows a gather cap")


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


def run_path(path, model, batch):
    """Phase 4 on one main path: the checks of the module docstring. The
    first frame runs eager (a new graph key), and its BEV maps, CPFPN
    outputs and decoder outputs are checked finite; the second captures
    the path's CUDA graphs where it has them (every path but the gather
    one) and the third, its launches counted from zero, replays them (a
    replayed launch is counted from its capture, models/graphs.py). Each
    of these two frames' task outputs and decoded scores must match the
    eager frame's on the same batch, so a NaN that a capture or a replay
    makes before `nan_to_num` shows there. Returns the replayed frame's
    launch counts and its launches per (kernel, shape) where a wrapper
    records its shape."""
    from cmtcoop_tpu_torch import _build, main_path
    from cmtcoop_tpu_torch.utils import profiling
    head = model.pts_bbox_head
    exts = extractors(model)
    finite, memory_len = [], []

    def check_finite(name):
        def hook(m, i, o):
            outs = o if isinstance(o, tuple) else (o,)
            finite.append((name, all(torch.isfinite(t).all() for t in outs)))
        return hook

    hooks = []
    for _, ext, _ in exts:
        hooks.append(ext.pts_neck.register_forward_hook(check_finite("bev")))
        if ext.use_camera:
            hooks.append(ext.img_neck.register_forward_hook(
                check_finite("cpfpn")))
    build_memory, run_decoder = head.build_memory, head.run_decoder

    def recording_build_memory(agent, *args, **kwargs):
        mem, pos = build_memory(agent, *args, **kwargs)
        memory_len.append(mem.shape[1])
        return mem, pos

    def checking_run_decoder(*args, **kwargs):
        out = run_decoder(*args, **kwargs)
        finite.append(("decoder", torch.isfinite(out).all()))
        return out

    head.build_memory = recording_build_memory
    head.run_decoder = checking_run_decoder
    with torch.inference_mode():
        ref_outs, ref_dec = main_path.frame(model, batch, path)  # eager
        for h in hooks:  # a hook's check would synchronise in a capture
            h.remove()
        del head.run_decoder
        served = [main_path.frame(model, batch, path)]  # captures
        memory_len.clear()
        _build.reset_counts()
        replayed = profiling.total("graph.replayed")
        served.append(main_path.frame(model, batch, path))  # replays
        replayed = profiling.total("graph.replayed") - replayed
        launches = dict(_build.launch_counts)
        shapes = dict(_build.launch_shapes)
    del head.build_memory
    bad = [name for name, ok in finite if not bool(ok)]
    # per agent: the BEV map, the CPFPN outputs with the camera branch,
    # the decoder pass
    per_agent = 3 if exts[0][1].use_camera else 2
    if bad or len(finite) != per_agent * len(exts):
        raise AssertionError(f"{path}: non-finite outputs before "
                             f"nan_to_num: {bad}")
    if (replayed > 0) == (path == main_path.GATHER_PATH):
        raise AssertionError(f"{path}: {replayed} graph replays in the "
                             "replayed frame")
    gap = 0.0  # the later frames against the eager frame, NaN never close
    for outs, d in served:
        pairs = [(o[k], r[k]) for o, r in zip(outs, ref_outs) for k in r]
        for got, want in pairs + [(d.scores, ref_dec.scores)]:
            if not torch.allclose(got.float(), want.float(), rtol=1e-2,
                                  atol=1e-2):
                raise AssertionError(f"{path}: a captured or replayed "
                                     "frame's outputs differ from the eager "
                                     "frame's")
            gap = max(gap, float((got.float() - want.float()).abs().max()))
    task_outs, dec = served[-1]
    for t in task_outs:
        for k, v in t.items():
            if not bool(torch.isfinite(v).all()) or v.shape[:3] != (6, 1,
                                                                     900):
                raise AssertionError(f"{path}: task output {k} "
                                     f"{tuple(v.shape)}")
    if dec.scores.shape != (300,) or dec.boxes.shape != (300, 9) or not bool(
            torch.isfinite(dec.boxes).all()):
        raise AssertionError(f"{path}: decode did not give 300 finite "
                             "slots")
    # per agent: a BEV token a cell of the grid / downsample_scale (32400
    # at 1440^2), plus a token a stride-16 cell of each camera view (4000
    # at 640x1600)
    gx, gy = head.grid_size
    bev = (gx // head.downsample_scale) * (gy // head.downsample_scale)
    want = [bev + (batch[p + "imgs"].shape[1] * (batch[p + "imgs"].shape[2]
                                                 // 16)
                   * (batch[p + "imgs"].shape[3] // 16) if ext.use_camera
                   else 0) for p, ext, _ in exts]
    if memory_len != want:
        raise AssertionError(f"{path}: memory lengths {memory_len}, "
                             f"expected {want}")
    log(f"main path {path}: eager, capture and replay frames, {replayed} "
        f"graph replays in the replayed frame, largest gap to the eager "
        f"frame {gap:.3g}, {int(dec.valid.sum())}/300 valid slots, memory "
        f"tokens per agent {memory_len}, replayed frame's launches "
        f"{launches}")
    check_launches(path, launches, main_path.PATH_KERNELS[path])
    if launches["neighbor_map"] != main_path.MAP_LAUNCHES[path]:
        raise AssertionError(f"{path}: {launches['neighbor_map']} "
                             "neighbour-map launches in a frame, not one a "
                             "map")
    return launches, shapes


def check_path_shapes(results, path, shapes):
    """Prints the shapes `path` launched each kernel at and raises unless
    every one of them was checked."""
    by_kernel = {}
    for name, shape in shapes:
        by_kernel.setdefault(name, []).append(list(shape))
    log(f"kernel shapes launched by {path}: {json.dumps(by_kernel)}")
    missing = set(shapes) - checked_shapes(results)
    if missing:
        raise AssertionError(f"{path} launched kernels at shapes no check "
                             f"took: {sorted(missing)}")


def slice_parity(name, model, batch, kernels, dev):
    """Phase 6 on one small detector: GPU kernels vs CPU plain, float32."""
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


TRAIN_STEPS = 2  # phase 5's steps on the benchmark batch


def run_train(dev):
    """Phase 5: TRAIN_STEPS full-width train steps and the checks of the
    module docstring. Returns the steps' launch counts, their launches per
    (kernel, shape) and the decoder's dropout rate."""
    from cmtcoop_tpu_torch import _build, main_path
    from cmtcoop_tpu_torch.models.petr_decoder import PETRDecoderLayer
    model, batch, opt, step = main_path.build_train_path(dev)
    with torch.no_grad():
        telemetry(model, batch)
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    params = [p.detach().clone() for p in opt.params]
    _build.reset_counts()
    metrics = [{k: float(v) for k, v in step(batch).items()}
               for _ in range(TRAIN_STEPS)]
    launches = dict(_build.launch_counts)
    shapes = dict(_build.launch_shapes)
    (rate,) = {m.dropout for m in model.modules()
               if isinstance(m, PETRDecoderLayer)}
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
    check_launches("train", launches,
                   main_path.PATH_KERNELS[main_path.TRAIN_PATH])
    if launches["neighbor_map"] != (main_path.MAP_LAUNCHES[
            main_path.TRAIN_PATH] * TRAIN_STEPS):
        raise AssertionError(f"train: {launches['neighbor_map']} "
                             f"neighbour-map launches in {TRAIN_STEPS} "
                             "steps, not one a map")
    log(f"train path {main_path.TRAIN_PATH}: {TRAIN_STEPS} steps, "
        f"{len(opt.params)} parameter tensors all with finite gradients and "
        f"moved, decoder dropout {rate:g}, launches {launches}")
    for i, m in enumerate(metrics):
        log(f"train step {i + 1} metrics: " + json.dumps(
            {k: round(v, 6) for k, v in m.items()}))
    return launches, shapes, rate


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


def check_launches(what, launches, kernels):
    """The kernels of `kernels` launched, every other kernel not."""
    from cmtcoop_tpu_torch import _build
    for k in _build.KERNELS:
        if (launches[k] > 0) != (k in kernels):
            raise AssertionError(f"{what}: kernel {k} launched "
                                 f"{launches[k]} times")


def metric_rows(work_dir):
    with open(Path(work_dir) / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def rel_err(a, b):
    return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in b)


def run_runtime(dev, smi):
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
    out = {"card": smi, "preset": name}

    def finite_rows(rows, steps, what):
        if [r["step"] for r in rows] != list(steps) or not all(
                math.isfinite(v) for r in rows for k, v in r.items()
                if k != "step"):
            raise AssertionError(f"{what}: metrics rows {rows}")

    # the two training runs, the eval hook and the stale-pack check take
    # PyTorch's deterministic algorithms (the sums of `index_add_` and of
    # the gather convs' backward in a fixed order), so that the resumed run
    # can replay the first one past its first step
    torch.use_deterministic_algorithms(True, warn_only=True)
    with tempfile.TemporaryDirectory() as tmp:
        try:
            # 7.1 the CLI, through main(argv), on the preset's own widths
            cli_dir = Path(tmp) / "cli"
            _build.reset_counts()
            cli = train_cli.main([
                name, "--synthetic", "--steps", str(RUNTIME_STEPS),
                "--epochs", "2", "--dtype", "bfloat16", "--seed", str(SEED),
                "--work-dir", str(cli_dir), "--log-interval", "1"])
            train_launches = dict(_build.launch_counts)
            del cli
            rows = metric_rows(cli_dir)
            finite_rows(rows, range(1, RUNTIME_STEPS + 1), "CLI run")
            steps = ckpt.all_steps(cli_dir / "ckpts")
            if steps != [2, 4]:
                raise AssertionError(f"CLI run: checkpoints at {steps}")
            check_launches("CLI run", train_launches,
                           main_path.PATH_KERNELS[main_path.TRAIN_PATH])
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
                summary, preds = run_eval(model, val, preset)
                evals.append(dict(step=step, preds=preds,
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
            if not trainer.resume(str(cli_dir / "ckpts"), step=2):
                raise AssertionError("resume found no checkpoint")
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
            eval_launches = first["launches"]
            check_launches("eval runner", eval_launches,
                           main_path.PATH_KERNELS[main_path.FUSION_PRESET])
            if not all(first["preds"].values()):
                raise AssertionError("eval runner: a sample with no box")
            # stale packs: another train step, the held eval model reloaded,
            # against a fresh eval model loaded from the same state_dict
            batch = to_device(next(synthetic_batch_iter(preset, 1, SEED)), dev)
            trainer.step_fn(batch)
            held = holder["model"]
            sd = trainer.model.state_dict()
            boxes = {}
            fresh = build_detector(preset, dtype=torch.bfloat16).to(dev)
            for what, model in (("reloaded", held), ("fresh", fresh)):
                model.load_state_dict(sd)
                boxes[what] = run_eval(model, val, preset)[1]
            stale_ok = boxes["reloaded"] == boxes["fresh"]
            moved = boxes["fresh"] != first["preds"]
            log(f"eval runner: step-4 map {ev['object/map']:.4f} nds "
                f"{ev['object/nds']:.4f} over {len(val)} samples; after "
                f"another step the reloaded eval model equals a fresh one: "
                f"{stale_ok} (its boxes moved: {moved}); launches "
                f"{eval_launches}")
            if not (stale_ok and moved):
                raise AssertionError("stale-pack check failed")
            trainer.close()
            del holder, held, fresh, trainer, batch
        finally:
            torch.use_deterministic_algorithms(False)
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
    log(f"runtime phase: spawned loader after CUDA init equals threads; "
        f"{smi}")
    print(json.dumps({"runtime": out}), flush=True)
    return train_launches, eval_launches


# phase 8: the on-disk slice. The raw archive's splits (frames, seed) at the
# TUMTraf Basler cameras' size, so the pipeline downscales for real; the
# loader in each worker mode over its first epoch at batch 1 (the 6 frames
# CBGS-resampled to 12); the train CLI's steps, its eval hook's samples and
# the test CLI's batch (3 val frames at 2: one full batch and a padded tail)
DISK_SPLITS = (("train", 6, 0), ("val", 3, 1))
DISK_IMG_HW = (1200, 1920)
DISK_STEPS = 4
DISK_EVAL_SAMPLES = 2


class CountedRuns:
    """Wraps a function (the train CLI's `make_eval_hook`'s hooks) to
    record the kernel launches made inside each call."""

    def __init__(self, fn):
        self.fn, self.runs = fn, []

    def __call__(self, *args, **kwargs):
        from cmtcoop_tpu_torch import _build
        before = dict(_build.launch_counts)
        out = self.fn(*args, **kwargs)
        self.runs.append({k: v - before[k]
                          for k, v in _build.launch_counts.items()})
        return out


def run_disk(dev, smi):
    """Phase 8: the on-disk slice on the card (the module docstring's
    checks). Returns the launch counts of create_data and the loaders, of
    the train CLI's steps, of its eval hook and of the test CLI."""
    import os
    import pickle
    import tempfile
    from cmtcoop_tpu_torch import _build, main_path
    from cmtcoop_tpu_torch.configs.presets import get_preset
    from cmtcoop_tpu_torch.data import native
    from cmtcoop_tpu_torch.data.loader import build_train_loader
    from cmtcoop_tpu_torch.data.synthetic_archive import build_raw_archive
    from cmtcoop_tpu_torch.tools import create_data
    from cmtcoop_tpu_torch.tools import test as test_cli
    from cmtcoop_tpu_torch.tools import train as train_cli
    from cmtcoop_tpu_torch.train import checkpoint as ckpt
    name = main_path.FUSION_PRESET
    preset = get_preset(name)
    out = {"card": smi, "preset": name}
    for mod in ("PIL", "torchvision"):
        try:
            out[mod] = __import__(mod).__version__
        except ImportError:
            out[mod] = None
    torch.cuda.empty_cache()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        raw, data = os.path.join(tmp, "raw"), os.path.join(tmp, "data")
        work, evald = os.path.join(tmp, "work"), os.path.join(tmp, "eval")
        _build.reset_counts()
        # 8.1 the raw archive; 8.2 create_data
        for split, frames, seed in DISK_SPLITS:
            build_raw_archive(raw, split, frames, seed, img_hw=DISK_IMG_HW)
        create_data.main(["a9coop_nusc", "--root-path", raw,
                          "--out-dir", data])
        for split, frames, _ in DISK_SPLITS:
            with open(os.path.join(
                    data, f"{preset.ann_prefix}_{split}.pkl"), "rb") as f:
                infos = pickle.load(f)["infos"]
            if len(infos) != frames:
                raise AssertionError(f"create_data: {len(infos)} {split} "
                                     f"infos, not {frames}")
            for info in infos:
                for key in ("vehicle_lidar_path", "infrastructure_lidar_path",
                            "registered_lidar_path"):
                    pts = np.fromfile(info[key], np.float32)
                    if pts.size == 0 or pts.size % 5 or not np.isfinite(
                            pts).all():
                        raise AssertionError(f"create_data: {info[key]} is "
                                             "no finite 5-column cloud")
        with open(os.path.join(data, preset.ann_prefix.replace(
                "infos", "dbinfos") + "_train.pkl"), "rb") as f:
            out["db_objects"] = sum(len(v) for v in pickle.load(f).values())
        if out["db_objects"] < 1:
            raise AssertionError("create_data: an empty GT database")

        # 8.3 the train loader in both worker modes
        if not native.loaded():
            raise AssertionError("native/libcmtcoop_host.so did not load")
        workers = min(4, os.cpu_count())
        loader, _ = build_train_loader(preset, data, 1, num_workers=workers,
                                       seed=SEED)
        if loader.dataset.pipeline.db_sampler is None:
            raise AssertionError("the GT database was not wired in")
        if len(loader) <= workers:
            raise AssertionError(f"loader: {len(loader)} batches an epoch")
        streams = {}
        for mode, procs in (("threads", False), ("spawn", True)):
            loader.use_processes = procs
            streams[mode] = list(loader.iter_epoch(0))
        out.update(loader_workers=workers, loader_batches=len(loader))
        same = all(a.keys() == b.keys() and all(
            np.array_equal(a[k], b[k]) for k in a)
            for a, b in zip(streams["threads"], streams["spawn"]))
        if not same:
            raise AssertionError("loader: the spawn mode's batches differ "
                                 "from the thread mode's")
        del streams, loader
        launches["create_data and loaders"] = dict(_build.launch_counts)

        # 8.4 the train CLI on --data-root, its eval hook counted apart
        hooks = []
        make_hook = train_cli.make_eval_hook

        def counted_hook(*args, **kwargs):
            hooks.append(CountedRuns(make_hook(*args, **kwargs)))
            return hooks[-1]

        train_cli.make_eval_hook = counted_hook
        _build.reset_counts()
        try:
            trainer = train_cli.main([
                name, "--data-root", data, "--work-dir", work,
                "--steps", str(DISK_STEPS), "--epochs", "1",
                "--num-workers", "2", "--eval-interval-steps",
                str(DISK_STEPS), "--eval-max-samples",
                str(DISK_EVAL_SAMPLES), "--dtype", "bfloat16",
                "--seed", str(SEED), "--log-interval", "1"])
        finally:
            train_cli.make_eval_hook = make_hook
        (evaluated,) = hooks[0].runs
        del trainer, hooks  # the train model and the hook's eval model
        launches["eval hook on disk"] = evaluated
        launches["train on disk"] = {
            k: v - evaluated[k] for k, v in _build.launch_counts.items()}
        check_launches("train CLI steps", launches["train on disk"],
                       main_path.PATH_KERNELS[main_path.TRAIN_PATH])
        check_launches("train CLI eval hook", launches["eval hook on disk"],
                       main_path.PATH_KERNELS[main_path.FUSION_PRESET])
        rows = metric_rows(work)
        steps = [r for r in rows if "eval" not in r]
        evals = [r["eval"] for r in rows if "eval" in r]
        if [r["step"] for r in steps] != list(range(1, DISK_STEPS + 1)) or \
                not all(math.isfinite(v) for r in steps for v in r.values()):
            raise AssertionError(f"train CLI: metrics rows {steps}")
        if len(evals) != 1 or not all(
                math.isfinite(evals[0].get(k, math.nan))
                for k in ("object/map", "object/nds")):
            raise AssertionError(f"train CLI: eval rows {evals}")
        saved = ckpt.all_steps(os.path.join(work, "ckpts"))
        if saved != [DISK_STEPS]:
            raise AssertionError(f"train CLI: checkpoints at {saved}")
        out["train_losses"] = [r["loss"] for r in steps]
        out["eval_hook"] = {k: evals[0][k] for k in ("object/map",
                                                     "object/nds")}
        torch.cuda.empty_cache()

        # 8.5 the test CLI on the step-4 checkpoint, val at batch 2
        _build.reset_counts()
        summary = test_cli.main([
            name, os.path.join(work, "ckpts"), "--data-root", data,
            "--split", "val", "--eval", "bbox", "--work-dir", evald,
            "--batch-size", "2", "--dtype", "bfloat16"])
        launches["test CLI"] = dict(_build.launch_counts)
        check_launches("test CLI", launches["test CLI"],
                       main_path.PATH_KERNELS[main_path.FUSION_PRESET])
        with open(os.path.join(evald, "metrics_summary.json")) as f:
            written = json.load(f)
        if not (math.isfinite(written["mean_ap"]) and os.path.exists(
                os.path.join(evald, "results_nusc.json"))):
            raise AssertionError(f"test CLI: mean_ap {written['mean_ap']}")
        out["test_cli"] = {"mean_ap": summary["mean_ap"],
                           "nd_score": summary["nd_score"]}
    torch.cuda.empty_cache()
    log(f"on-disk phase: PIL {out['PIL']}, torchvision "
        f"{out['torchvision']}; {out['db_objects']} GT objects; loader at "
        f"batch 1, {workers} workers, {out['loader_batches']} batches, "
        f"threads and spawn bit-equal; train CLI losses "
        f"{[round(v, 4) for v in out['train_losses']]}, eval hook map "
        f"{out['eval_hook']['object/map']:.4f}; test CLI mean_ap "
        f"{summary['mean_ap']:.4f}; {smi}")
    print(json.dumps({"disk": out}), flush=True)
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "check needs an NVIDIA GPU")
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
    lib_path = _build.build()
    _build.lib()
    log(f"build: {lib_path.name}")

    # the LiDAR path's model and batch, with its clouds' telemetry (zero
    # drops), which also gives phase 3 its pillar shapes
    model, batch = main_path.build_main_path(dev, main_path.PRESET)
    with torch.inference_mode():
        levels = telemetry(model, batch)

    # 3. the kernels whose inputs come from the encoders or from no path
    results = {}
    with torch.inference_mode():
        pillar_kernel_phases(levels, results, dev)
        neighbor_map_phases(pillar_map_calls(model, batch)
                            + gather_map_calls(model, batch), results)
        off_path_phases(results, dev)
    del levels

    # 4. the main paths, one or two models on the card at a time; kernels
    # 3, 4 and 6 at the shapes each launched
    launches = {}

    def path_phase(path, model, batch):
        launches[path], shapes = run_path(path, model, batch)
        with torch.inference_mode():
            path_kernel_phases(results, shapes, path, dev)
        check_path_shapes(results, path, shapes)

    path_phase(main_path.PRESET, model, batch)
    path = main_path.GATHER_PATH
    gather, gather_batch = main_path.build_main_path(dev, path)
    with torch.inference_mode():
        gather_telemetry(gather, gather_batch)
    path_phase(path, gather, gather_batch)
    gather_vs_pillar(gather, model, batch)
    del model, batch, gather, gather_batch
    torch.cuda.empty_cache()
    preset = main_path.FUSION_PRESET
    model, batch = main_path.build_main_path(dev, preset)
    with torch.inference_mode():
        telemetry(model, batch)
    path_phase(preset, model, batch)
    del model, batch
    torch.cuda.empty_cache()
    # the nuScenes detector: kernels 1, 2 and 9 on its own cloud first
    path = main_path.NUSC_PATH
    model, batch = main_path.build_main_path(dev, path)
    with torch.inference_mode():
        pillar_kernel_phases(telemetry(model, batch), results, dev)
        neighbor_map_phases(pillar_map_calls(model, batch), results)
    path_phase(path, model, batch)
    del model, batch
    torch.cuda.empty_cache()
    # its real-time variant (ResNet-50, 320x800 views, a 1024^2 grid)
    path = main_path.R50_PATH
    model, batch = main_path.build_main_path(dev, path)
    with torch.inference_mode():
        pillar_kernel_phases(telemetry(model, batch), results, dev)
        neighbor_map_phases(pillar_map_calls(model, batch), results)
    path_phase(path, model, batch)
    del model, batch
    torch.cuda.empty_cache()

    # 5. the train path, then kernels 7 and 8 at the shapes it launched
    launches[main_path.TRAIN_PATH], train, rate = run_train(dev)
    torch.cuda.empty_cache()
    train_kernel_phases(results, train, rate, dev)
    check_path_shapes(results, main_path.TRAIN_PATH, train)

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
    launches["trainer"], launches["eval runner"] = run_runtime(dev, smi)

    # 8. the on-disk slice: archive, create_data, loaders, train, test CLIs
    launches.update(run_disk(dev, smi))

    kernels = []
    for name in _build.KERNELS:
        src, replaces = SOURCES[name]
        r = results[name]
        per_path = {p: n[name] for p, n in launches.items()}
        kernels.append(dict(name=name, route="cuda", impl=IMPLS[name],
                            source=src, replaces=replaces,
                            launches=sum(per_path.values()),
                            launches_per_path=per_path,
                            max_abs_err=r["max_abs_err"], cases=r["cases"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
