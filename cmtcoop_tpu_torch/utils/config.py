"""Config override plumbing (the reference's `--cfg-options` deep-merge,
train.py:81-96): apply `key=value` strings onto a Preset. Counterpart of
cmtcoop_tpu/utils/config.py on the port's `Preset`."""
from __future__ import annotations

import ast
import dataclasses
from typing import Sequence

from cmtcoop_tpu_torch.configs.presets import Preset


def _coerce(value: str):
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def apply_overrides(preset: Preset, overrides: Sequence[str]) -> Preset:
    """`apply_overrides(p, ["max_gt=64", "pc_range=(-50,-50,-5,50,50,3)"])`"""
    updates = {}
    valid = {f.name for f in dataclasses.fields(Preset)}
    for ov in overrides or ():
        key, _, val = ov.partition("=")
        key = key.strip()
        if key not in valid:
            raise KeyError(
                f"unknown preset field {key!r}; valid: {sorted(valid)}")
        updates[key] = _coerce(val.strip())
    return dataclasses.replace(preset, **updates)
