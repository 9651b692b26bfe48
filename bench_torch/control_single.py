"""The control of a single-agent cell's comparison (traffic kind
`eval_closed_single`): `control.py` over that kind's generator
(generator_single.py) and reference (reference_single.py). The plain
reference is put in the program's place, computed one precision step
below the configuration's (float8 e4m3 operands for bfloat16;
`precision="fp8"`), over the same pool frames, served as the program
serves (compare.py `as_served`: the reference's top-k, as many as its
decode kept) and compared with the float32 reference by the cell's
numbers. Each seed prints one JSON line of the widest gaps over its pool and
whether the cell's limits would call it correct (they must not):

    python -m bench_torch.control_single --workload <cell> --seeds 1 2 3

The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional

import torch

from bench_torch import compare, generator_single, program
from bench_torch.reference_single import SingleReference
from bench_torch.run import ROOT, load_cell
from bench_torch.weights import make_weights


def control_gaps(cell, seed: int, device) -> dict:
    """The control's widest gaps over the pool of `seed`."""
    cfg = cell.config
    model = program.build_eval_model(cfg, torch.device("meta"))
    shapes = program.state_shapes(model)
    del model
    pool = generator_single.frame_pool(cell.traffic, cfg, seed)
    params = make_weights(shapes, seed, device)
    ref = SingleReference(cfg, params)
    low = SingleReference(cfg, params, precision="fp8")
    names = program.preset(cfg).class_names
    worst = dict.fromkeys(compare.NAMES, 0.0)
    for host in pool:
        gaps = compare.frame_gaps(compare.as_served(low.frame(host), names),
                                  ref.frame(host), names)
        for k in compare.NAMES:
            worst[k] = max(worst[k], gaps[k])
    limits = {k: float(v) for k, v in cell.limits.items()}
    return dict(workload=cell.name, seed=seed, **worst,
                correct=compare.verdict(worst, limits))


def main(argv: Optional[List[str]] = None, root: Path = ROOT) -> List[dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    cell = load_cell(args.workload, root)
    out = []
    for seed in args.seeds:
        out.append(control_gaps(cell, seed, torch.device(args.device)))
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main()
