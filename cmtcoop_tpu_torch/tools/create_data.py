"""Data preparation CLI of the port (counterpart of the root
tools/create_data.py; reference tools/create_data.py:245-374).

    python -m cmtcoop_tpu_torch.tools.create_data a9coop_nusc \\
        --root-path RAW --out-dir DATA
    python -m cmtcoop_tpu_torch.tools.create_data a9_nusc \\
        --root-path RAW --out-dir DATA

`a9coop_nusc` converts a raw TUMTraf cooperative archive (PCD clouds,
OpenLabel labels, camera images) into `a9_nusc_coop_infos_{train,val,
test}.pkl` plus the GT-paste database (`--skip-gt-database` leaves it out);
`a9_nusc` converts the intersection archive into `a9_nusc_infos_*.pkl`. The
`a9_kitti` and `nuscenes` converters are not ported yet (ROADMAP.md): they
exit 2.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

NOT_PORTED = ("a9_kitti", "nuscenes")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m cmtcoop_tpu_torch.tools.create_data")
    ap.add_argument("dataset", choices=["a9coop_nusc", "a9_nusc", *NOT_PORTED])
    ap.add_argument("--root-path", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--skip-gt-database", action="store_true")
    args = ap.parse_args(argv)
    if args.dataset in NOT_PORTED:
        ap.error(f"the {args.dataset} converter is not ported yet; it is "
                 "queued in ROADMAP.md")
    return args


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    if args.dataset == "a9coop_nusc":
        from cmtcoop_tpu_torch.data.converters import a9coop
        a9coop.convert_all(args.root_path, args.out_dir)
        if not args.skip_gt_database:
            a9coop.create_gt_database(args.out_dir)
    else:
        from cmtcoop_tpu_torch.data.converters import a9_nusc
        a9_nusc.convert_all(args.root_path, args.out_dir)


if __name__ == "__main__":
    main()
