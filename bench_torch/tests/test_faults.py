"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven at
the small detector's size on the CPU, with each fault an eval cell can
have planted in the program. An eval cell at batch 1 on one chip has one:
an answer altered where it is produced, here a box moved and a score
raised. The small fusion cell compares the numbers that the flagship
cell's limits file names (conftest.py), so each fault is caught by those
numbers. (A relabel or another query's logits moves only the per-query
score numbers, which no cell compares: at full size the fp8 control
reads under three times the program there. Their response is in
test_compare.py.)"""
from __future__ import annotations

import pytest

from bench_torch import run as bench_run


def _shift_boxes(dx):
    import cmtcoop_tpu_torch.core.coder as coder
    real = coder.decode_boxes

    def decode(*args, **kwargs):
        dec = real(*args, **kwargs)
        boxes = dec.boxes.clone()
        boxes[:, 0] += dx
        return dec._replace(boxes=boxes)

    return coder, "decode_boxes", decode


def _raise_scores():
    import cmtcoop_tpu_torch.data.formats as formats
    real = formats.decoded_to_eval_boxes

    def to_boxes(dec, names, ts):
        out = real(dec, names, ts)
        for b in out:
            b["detection_score"] = min(1.0, b["detection_score"] + 0.05)
        return out

    return formats, "decoded_to_eval_boxes", to_boxes


FAULTS = {"box moved 2 m": lambda: _shift_boxes(2.0),
          "score raised": _raise_scores}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_broken_answer_is_not_correct(checkout, capsys, monkeypatch, fault):
    module, attr, fn = FAULTS[fault]()
    monkeypatch.setattr(module, attr, fn)
    res = bench_run.run(["--workload", "tiny_fusion.eval", "--seed", "31",
                         "--seconds", "0.3", "--trace", "0"], root=checkout,
                        allow_cpu=True)
    capsys.readouterr()
    assert res["correct"] is False
    over = [k for k, c in res["checks"].items()
            if k != "frames_compared" and c["value"] > c["limit"]]
    assert over, res["checks"]
