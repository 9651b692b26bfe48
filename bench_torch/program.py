"""What the benchmark takes from the program under test, the PyTorch and
CUDA port `cmtcoop_tpu_torch`: its model as a configuration file asks,
filled with the harness's weights, and the per-batch body of its offline
eval (`train/eval_hook.py` `run_eval`): `to_device` -> `make_eval_forward`
-> `core/coder.decode_boxes` -> `data/formats.decoded_to_eval_boxes`.

The program is imported by the functions here, never when this module is
imported, so the harness's own modules load without it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def tuples(x):
    """JSON lists -> tuples, nested (the program's presets hold tuples)."""
    if isinstance(x, list):
        return tuple(tuples(v) for v in x)
    if isinstance(x, dict):
        return {k: tuples(v) for k, v in x.items()}
    return x


def preset(config: dict):
    from cmtcoop_tpu_torch.configs.presets import get_preset
    return dataclasses.replace(get_preset(config["preset"]),
                               **tuples(config.get("preset_overrides", {})))


def build_eval_model(config: dict, device) -> torch.nn.Module:
    """The eval-mode detector of `config`, built on `device`, computing in
    the configuration's dtype (its parameters float32, not yet filled)."""
    from cmtcoop_tpu_torch.models.build import build_detector
    prog = tuples(config.get("program", {}))
    with torch.device(device):
        model = build_detector(
            preset(config), train=False, dtype=DTYPES[config["dtype"]],
            extractor_kwargs=dict(prog.get("extractor_kwargs", {})),
            head_kwargs=dict(prog.get("head_kwargs", {})))
    return model.eval()


def state_shapes(model: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


@torch.no_grad()
def load_weights(model: torch.nn.Module,
                 weights: Dict[str, torch.Tensor]) -> None:
    """Copy the harness's weights into the model's own tensors, in place
    (which bumps their versions, so the program re-packs its operands)."""
    state = model.state_dict(keep_vars=True)
    if set(state) != set(weights):
        raise ValueError("the weights do not name the model's state")
    for k, t in state.items():
        t.copy_(weights[k])


def eval_server(model: torch.nn.Module, config: dict, device,
                span: Callable[[str], object]):
    """serve(host frame) -> the frame's boxes on the host, as the program's
    offline eval makes them for one sample at batch 1; `span(name)` wraps
    the copy-in (`entry.copy_in`) and the decode with its readback
    (`entry.decode`)."""
    from cmtcoop_tpu_torch.core.coder import decode_boxes
    from cmtcoop_tpu_torch.data.formats import decoded_to_eval_boxes
    from cmtcoop_tpu_torch.train.eval_hook import (make_eval_forward,
                                                   to_device)
    forward = make_eval_forward(model)
    names = preset(config).class_names

    def serve(host: Dict, timestamp: int = 0) -> List[dict]:
        with span("entry.copy_in"):
            batch = to_device(host, device)
        logits, codes = forward(batch)
        with span("entry.decode"):
            dec = decode_boxes([lg[0] for lg in logits],
                               [c[0] for c in codes])
            return decoded_to_eval_boxes(dec, names, timestamp)

    return serve
