"""The comparison's numbers on a made-up reference answer with many
classes and spread scores: the answer served as the reference serves it
reads 0 on every number; a box moved moves the box numbers, and a score
raised, a class relabelled or each query given another query's class
logits moves the per-query score numbers far past what the bf16 program
reads at full size (at most 0.0052 over 12 seeds a cell)."""
from __future__ import annotations

import numpy as np
import pytest

from bench_torch import compare
from bench_torch.reference import RefOutput

NAMES = tuple(f"c{i}" for i in range(10))


def _answer(seed=0, queries=900, k=300):
    rng = np.random.default_rng(seed)
    boxes = np.column_stack([
        rng.uniform(-60, 60, (queries, 2)), rng.uniform(-3, 1, queries),
        rng.uniform(0.5, 5.0, (queries, 3)), rng.uniform(-3, 3, queries),
        rng.normal(0, 2, (queries, 2))])
    scores = rng.uniform(0.0, 1.0, (queries, len(NAMES)))
    top = np.sort(scores.reshape(-1))[::-1][:k]
    return RefOutput(boxes=boxes, scores=scores, top_scores=top)


def _relabel(served):
    for b in served:
        i = NAMES.index(b["detection_name"])
        b["detection_name"] = NAMES[(i + 1) % len(NAMES)]


def _raise(served):
    for b in served:
        b["detection_score"] += 0.05


def _other_query(ref):
    """Each query scored with its neighbour's class logits."""
    return ref._replace(scores=np.roll(ref.scores, 1, axis=0))


def test_served_reference_reads_zero():
    ref = _answer()
    gaps = compare.frame_gaps(compare.as_served(ref, NAMES), ref, NAMES)
    assert all(gaps[k] < 1e-6 for k in compare.NAMES), gaps


def _move(served):
    for b in served:
        b["translation"] = (b["translation"][0] + 2.0,
                            *b["translation"][1:])


@pytest.mark.parametrize("fault, number", [
    ("move", "box_gap"), ("move", "box_rms"),
    ("relabel", "query_score_gap"), ("relabel", "query_score_rms"),
    ("raise", "query_score_gap"), ("raise", "score_gap"),
    ("other query", "query_score_gap"),
    ("other query", "query_score_rms")])
def test_altered_answer_moves_its_number(fault, number):
    ref = _answer(1)
    if fault == "other query":
        served = compare.as_served(_other_query(ref), NAMES)
    else:
        served = compare.as_served(ref, NAMES)
        {"move": _move, "relabel": _relabel, "raise": _raise}[fault](served)
    gaps = compare.frame_gaps(served, ref, NAMES)
    assert gaps[number] > 0.04, gaps
