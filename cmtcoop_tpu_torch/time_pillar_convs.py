"""Kernels 1 and 2 (the pillar convs) of two checkouts of the repository,
at every conv of the pillar encoder on each agent's cloud, on one card.

    python -m cmtcoop_tpu_torch.time_pillar_convs --base <other checkout> \\
        [--iters 5]

One worker process per checkout (`--base`, e.g. the parent commit unpacked
with `git archive` into `build/`, then this one) imports that checkout's
`cmtcoop_tpu_torch`, builds the LiDAR path's model and batch
(`main_path.build_main_path`, seeded), pillarizes both agents' clouds and
builds every level's grid, occupancy and maps as the eval encoder does.
It then calls the public `fused_pillar_conv` (the signature every checkout
keeps) at the 13 convs of each cloud (`CONVS`, conv_input to conv_out) on
bf16 inputs made from one seed, as the eval encoder calls it (down convs
fold their occupancy). Per conv it reports:

- `kernel_ms`: the device time of the kernels whose name holds
  `pillar_conv`, a call (a `torch.profiler` trace of `--iters` calls);
- `call_ms`: the whole call's device time from CUDA events (its weight
  packing or cast, row compaction and occupancy fold too), `--iters`
  calls queued behind a spin of the device.

Prints one JSON object: per checkout every conv's times and their sums a
frame (both clouds, each conv weighted by its launches in the encoder: 21
an agent, 42 a frame), and the card's `nvidia-smi` name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SEED = 0

# (what, level, Cin, Cout, kind); kind "subm" (occupancy given), "resid"
# (with the block's residual), "down" (stride 2 into the next level,
# occupancy folded), "out" (conv_out, KB 1). Each level's conv1 and conv2
# run twice an agent (two blocks a level), the others once.
CONVS = (("conv_input", 0, 5, 16, "subm"),
         ("L0 conv1", 0, 16, 16, "subm"), ("L0 conv2", 0, 16, 16, "resid"),
         ("L0->L1 down", 0, 16, 32, "down"),
         ("L1 conv1", 1, 32, 32, "subm"), ("L1 conv2", 1, 32, 32, "resid"),
         ("L1->L2 down", 1, 32, 64, "down"),
         ("L2 conv1", 2, 64, 64, "subm"), ("L2 conv2", 2, 64, 64, "resid"),
         ("L2->L3 down", 2, 64, 128, "down"),
         ("L3 conv1", 3, 128, 128, "subm"),
         ("L3 conv2", 3, 128, 128, "resid"),
         ("conv_out", 3, 128, 128, "out"))
DOWN_Z_PAD = (1, 1, 0)


def _levels(batch, agent, ext):
    """Every level's grid, occupancy, map and down map for one cloud."""
    from cmtcoop_tpu_torch.main_path import PILLAR_CAPS
    from cmtcoop_tpu_torch.ops import pillars as pu
    pc, pm, occ, _, _ = ext.pillarize(batch[agent + "points"][0],
                                      batch[agent + "points_mask"][0],
                                      return_stats=True)
    d, h, w = ext.pts_middle_encoder.sparse_shape
    grid = pu.PillarGrid(pc, pm, (h, w), d)
    levels = [dict(grid=grid, occ=occ, nbr=pu.pillar_neighbor_map(grid))]
    for cap, zp in zip(PILLAR_CAPS[1:], DOWN_Z_PAD):
        out = pu.pillar_downsample_grid(grid, cap)
        nbr_dn = pu.pillar_conv_neighbor_map(grid, out)
        occ = pu.occ_downsample(occ, nbr_dn, 3, 2, zp)
        levels[-1]["nbr_dn"] = nbr_dn
        grid = out
        levels.append(dict(grid=grid, occ=occ,
                           nbr=pu.pillar_neighbor_map(grid)))
    return levels


def _launches(what: str) -> int:
    """The conv's launches an agent in the eval encoder."""
    return 2 if what.endswith(("conv1", "conv2")) else 1


def _kernel_us(trace_path: Path) -> float:
    """Device us of the pillar-conv kernels in a Chrome trace."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    us = sum(e["dur"] for e in events
             if e.get("ph") == "X" and e.get("cat") == "kernel"
             and "pillar_conv" in e.get("name", ""))
    if not us:
        raise SystemExit("time_pillar_convs: the trace holds no pillar-conv "
                         "kernel")
    return us


def worker(root: str, iters: int) -> None:
    """Times one checkout's `fused_pillar_conv`; prints one JSON line."""
    sys.path[0] = root  # this checkout's package, not the caller's
    import torch

    from cmtcoop_tpu_torch import main_path
    from cmtcoop_tpu_torch.ops import pillars as pu
    from cmtcoop_tpu_torch.ops.pillar_fused import fused_pillar_conv
    dev = torch.device("cuda")
    model, batch = main_path.build_main_path(dev, main_path.PRESET)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    trace = REPO / "build" / "time_pillar_convs" / "trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    rows = []
    with torch.inference_mode():
        for agent in ("vehicle_", "infrastructure_"):
            levels = _levels(batch, agent, getattr(model, agent + "model"))
            ident = pu.identity_map(levels[3]["grid"])
            for what, li, cin, cout, kind in CONVS:
                lv = levels[li]
                occ_in = lv["occ"]
                kb = 1 if kind == "out" else 9
                kw = dict(relu=True)
                if kind == "down":
                    nbr = lv["nbr_dn"]
                    kw.update(z_stride=2, z_pad=DOWN_Z_PAD[li],
                              occ_in=occ_in, fold_occ=True)
                elif kind == "out":
                    nbr = ident
                    kw.update(z_stride=2, z_pad=0, occ_out=pu.occ_downsample(
                        occ_in, ident, 3, 2, 0))
                else:
                    nbr = lv["nbr"]
                    kw["occ_out"] = occ_in
                x = (randn(*occ_in.shape, cin)
                     * occ_in[..., None]).to(torch.bfloat16)
                w = randn(3 * kb, cin, cout,
                          scale=(3 * kb * cin) ** -0.5).to(torch.bfloat16)
                kw.update(scale=1.0 + 0.1 * randn(cout),
                          bias=0.1 * randn(cout))
                if kind == "resid":
                    kw["residual"] = (randn(*occ_in.shape, cout)
                                      * occ_in[..., None]).to(torch.bfloat16)

                def call(x=x, nbr=nbr, w=w, kw=kw):
                    return fused_pillar_conv(x, nbr, w, **kw)

                for _ in range(2):
                    call()
                torch.cuda.synchronize()
                acts = [torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    for _ in range(iters):
                        call()
                    torch.cuda.synchronize()
                prof.export_chrome_trace(str(trace))
                kernel_ms = _kernel_us(trace) / 1e3 / iters
                torch.cuda._sleep(40_000_000)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    call()
                end.record()
                torch.cuda.synchronize()
                rows.append(dict(agent=agent.rstrip("_"), conv=what,
                                 p_z_in=list(occ_in.shape), cin=cin,
                                 cout=cout, launches=_launches(what),
                                 kernel_ms=kernel_ms,
                                 call_ms=start.elapsed_time(end) / iters))
    print(json.dumps(rows), flush=True)


def _run(root: Path, iters: int) -> list:
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--worker",
         str(root), "--iters", str(iters)], cwd=root, capture_output=True,
        text=True, timeout=1800)
    if out.returncode:
        raise SystemExit(f"worker for {root} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--base", help="the other checkout's root")
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        worker(args.worker, args.iters)
        return {}
    if not args.base:
        parser.error("--base is required")
    result = {}
    for label, root in (("base", Path(args.base).resolve()), ("this", REPO)):
        rows = _run(root, args.iters)
        result[label] = dict(
            convs=rows, frame_launches=sum(r["launches"] for r in rows),
            **{f"frame_{k}": sum(r[k] * r["launches"] for r in rows)
               for k in ("kernel_ms", "call_ms")})
    result["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(result, indent=1), flush=True)
    return result


if __name__ == "__main__":
    main()
