"""The control of a cell of traffic kind `eval_closed_resnet`:
`control_single.py` with its reference bound to
`reference_resnet.ResNetReference`. The plain reference, computed one
precision step below the configuration's (float8 e4m3 operands for
bfloat16), is put in the program's place over the same pool frames and
compared with the float32 reference by the cell's numbers; each seed
prints one JSON line of the widest gaps over its pool and whether the
cell's limits would call it correct (they must not):

    python -m bench_torch.control_resnet --workload <cell> --seeds 1 2 3

The benchmark's own runs never run it.
"""
from __future__ import annotations

from typing import List, Optional
from unittest import mock

from bench_torch import control_single
from bench_torch.reference_resnet import ResNetReference


def main(argv: Optional[List[str]] = None, **kwargs) -> List[dict]:
    with mock.patch.object(control_single, "SingleReference",
                           ResNetReference):
        return control_single.main(argv, **kwargs)


if __name__ == "__main__":
    main()
