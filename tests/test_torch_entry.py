"""The eval entry's transfers (train/eval_hook.to_device, core/coder
decode_boxes, data/formats.decoded_to_eval_boxes): on the CPU, the packed
readback against the per-array reads it replaced, the decode's cached
constants and the uploads that stay off the pinned ring; on the card
(`cuda` marker), the staged upload bit-equal to `Tensor.to`, a ring slot
refilled only after its DMA, the counters, and a decode and packing that
never wait for the card. Torch and the port only, no jax (on the card:
python -m pytest tests/test_torch_entry.py -m cuda --noconftest -q)."""

import numpy as np
import pytest
import torch

from cmtcoop_tpu_torch.core.coder import DecodedBoxes, decode_boxes
from cmtcoop_tpu_torch.data import formats
from cmtcoop_tpu_torch.train.eval_hook import to_device
from cmtcoop_tpu_torch.utils import constants, profiling, staging

NUSC_TASK_WIDTHS = (1, 2, 2, 1, 2, 2)  # nuScenes' six task groups


class Names:
    """Class names for any label id."""

    def __getitem__(self, i):
        return f"class_{i}"


def per_array(decoded, class_names, timestamp):
    """`decoded_to_eval_boxes` as it read the four arrays one by one and
    built each dict element by element (the reference)."""
    def host(x):
        return x.detach().cpu().numpy() if hasattr(x, "detach") \
            else np.asarray(x)
    boxes, scores, labels, valid = map(host, decoded)
    out = []
    for i in np.where(valid)[0]:
        b = boxes[i]
        out.append(dict(
            translation=(float(b[0]), float(b[1]),
                         float(b[2] + b[5] / 2.0)),
            size=(float(b[3]), float(b[4]), float(b[5])),
            yaw=float(b[6]),
            velocity=(float(b[7]), float(b[8])) if b.shape[0] > 7 else (0, 0),
            detection_name=class_names[int(labels[i])],
            detection_score=float(scores[i]),
            ego_dist=float(np.hypot(b[0], b[1])),
            num_pts=-1,
            timestamp=timestamp,
        ))
    return out


def decoded(rng, k=300, width=9, valid=0.6, top_label=9,
            dtype=np.float32):
    boxes = rng.normal(scale=30.0, size=(k, width)).astype(dtype)
    labels = rng.integers(0, top_label + 1, k).astype(np.int32)
    labels[-1] = top_label
    return DecodedBoxes(torch.from_numpy(boxes),
                        torch.from_numpy(rng.uniform(size=k).astype(dtype)),
                        torch.from_numpy(labels),
                        torch.from_numpy(rng.uniform(size=k) < valid))


CASES = {
    "no valid row": dict(valid=0.0),
    "every row valid": dict(valid=1.1),
    "some rows valid": dict(),
    "highest nuScenes label": dict(top_label=9, valid=1.1),
    "highest exact label": dict(top_label=2 ** 24 - 1, valid=1.1),
    "box7": dict(width=7),
    "float64": dict(dtype=np.float64),
}


@pytest.mark.parametrize("case", list(CASES))
def test_packed_readback_equals_the_per_array_reads(case):
    dec = decoded(np.random.default_rng(3), **CASES[case])
    ref = per_array(dec, Names(), 7)
    assert formats.decoded_to_eval_boxes(dec, Names(), 7) == ref
    # numpy arrays take no packing, and give the same dicts
    host = DecodedBoxes(*(x.numpy() for x in dec))
    assert formats.decoded_to_eval_boxes(host, Names(), 7) == ref
    assert len(ref) == int(dec.valid.sum())


def test_fault_tests_decoded_boxes_read_back_as_before():
    """A DecodedBoxes whose boxes were cloned and moved on the CPU, as the
    harness's fault tests build one, after the real decode."""
    rng = np.random.default_rng(5)
    logits = [torch.from_numpy(rng.normal(size=(900, w)).astype(np.float32))
              for w in NUSC_TASK_WIDTHS]
    codes = [torch.from_numpy(rng.normal(size=(900, 10)).astype(np.float32))
             for _ in NUSC_TASK_WIDTHS]
    dec = decode_boxes(logits, codes, post_center_range=(-61.2, -61.2, -10.0,
                                                          61.2, 61.2, 10.0))
    boxes = dec.boxes.clone()
    boxes[:, 0] += 2.0
    moved = dec._replace(boxes=boxes)
    names = [f"c{i}" for i in range(10)]
    for d in (dec, moved):
        assert formats.decoded_to_eval_boxes(d, names, 3) == \
            per_array(d, names, 3)
    packed = formats.pack_decoded(moved)
    assert packed.shape == (300, 12) and packed.dtype == torch.float32


def test_decode_constants_come_from_the_cache(monkeypatch):
    """A second decode with the same task widths and range builds no
    tensor from host values; another range builds its own, once."""
    made = []
    real = torch.tensor

    def tensor(*args, **kwargs):
        made.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(torch, "tensor", tensor)
    rng = np.random.default_rng(0)
    logits = [torch.from_numpy(rng.normal(size=(20, w)).astype(np.float32))
              for w in (3, 1, 2)]
    codes = [torch.from_numpy(rng.normal(size=(20, 10)).astype(np.float32))
             for _ in range(3)]
    first = (-41.5, -41.5, -7.25, 41.5, 41.5, 7.25)
    decode_boxes(logits, codes, 10, post_center_range=first)
    made.clear()
    a = decode_boxes(logits, codes, 10, post_center_range=first)
    assert made == []
    b = decode_boxes(logits, codes, 10,
                     post_center_range=(-9.0, -9.0, -1.0, 9.0, 9.0, 1.0))
    assert made == [(-9.0, -9.0, -1.0, 9.0, 9.0, 1.0)]
    assert torch.equal(a.scores, b.scores)
    assert constants.constant(first, torch.float32, "cpu") is \
        constants.constant(list(first), torch.float32, "cpu")


def test_uploads_to_the_cpu_and_meta_do_not_stage(monkeypatch):
    """Only a CUDA destination goes through the pinned ring; the CPU and
    `meta` keep `Tensor.to`, and count as they did."""
    def refuse(*args):
        raise AssertionError("staged an upload off the card")

    monkeypatch.setattr(staging, "upload", refuse)
    batch = {"imgs": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
             "mask": np.ones(5, bool)}
    before = profiling.total("h2d.pageable_bytes")
    out = to_device(batch, "cpu")
    for k, v in batch.items():
        np.testing.assert_array_equal(out[k].numpy(), v)
    out = to_device(batch, "meta")
    assert {k: t.device.type for k, t in out.items()} == dict.fromkeys(
        batch, "meta")
    assert profiling.total("h2d.pageable_bytes") - before == sum(
        v.nbytes for v in batch.values())


# -- on the card -------------------------------------------------------------

def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (on the card: python -m pytest "
                    "tests/test_torch_entry.py -m cuda --noconftest)")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes, for a bit-for-bit comparison."""
    return t.contiguous().reshape(-1).view(torch.uint8).cpu()


def host_arrays(rng):
    """Arrays of each kind an upload takes: float32 with every bit
    pattern, bool, int64, a non-contiguous view, one larger than the
    whole ring, a scalar and an empty one."""
    ring_bytes = staging.SLOTS * staging.SLOT_BYTES
    big = rng.integers(0, 2 ** 32, ring_bytes // 4 + 12345,
                       dtype=np.uint32)
    return {"f32": rng.integers(0, 2 ** 32, (3, 1000),
                                dtype=np.uint32).view(np.float32),
            "bool": rng.uniform(size=(7, 33)) < 0.5,
            "i64": rng.integers(-2 ** 62, 2 ** 62, (5, 9)),
            "view": rng.normal(size=(64, 48)).astype(np.float32)[::3, 5:40],
            "big": big.view(np.float32),
            "scalar": np.array(2.5, np.float32),
            "empty": np.zeros((0, 4), np.float32)}


@pytest.mark.cuda
def test_staged_upload_is_bit_equal_to_tensor_to():
    dev = card()
    batch = host_arrays(np.random.default_rng(11))
    out = to_device(batch, dev)
    torch.cuda.synchronize()
    for k, v in batch.items():
        want = torch.as_tensor(v).to(dev)
        got = out[k]
        assert got.device.type == "cuda" and got.dtype == want.dtype, k
        assert got.shape == want.shape, k
        assert torch.equal(_bits(got), _bits(want)), k


@pytest.mark.cuda
@pytest.mark.parametrize("slots,slot_bytes", [(2, 1 << 16),
                                              (staging.SLOTS,
                                               staging.SLOT_BYTES)])
def test_a_slot_is_refilled_only_after_its_dma(monkeypatch, slots,
                                               slot_bytes):
    """Two frames uploaded back to back behind a kernel that holds the
    stream, each overwritten on the host as soon as `to_device` returns:
    both arrive whole, so no slot was refilled before its DMA had read it
    and no DMA read the caller's arrays after the return."""
    dev = card()
    ring = staging.PinnedRing(slots, slot_bytes)
    monkeypatch.setattr(staging, "ring", lambda device: ring)
    rng = np.random.default_rng(2)
    n = (slots * slot_bytes * 5) // 8  # 2.5 rings of float32 a frame
    frames = [{"a": rng.normal(size=n).astype(np.float32),
               "m": rng.uniform(size=n // 3) < 0.5} for _ in range(2)]
    want = [{k: v.copy() for k, v in f.items()} for f in frames]
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s of one SM
    got = []
    for f in frames:
        got.append(to_device(f, dev))
        for v in f.values():
            v[...] = 0
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k].cpu().numpy(), w[k])


@pytest.mark.cuda
def test_cuda_upload_counts_no_pageable_bytes():
    dev = card()
    batch = host_arrays(np.random.default_rng(4))
    before = {k: profiling.total(k)
              for k in ("h2d.bytes", "h2d.pageable_bytes")}
    to_device(batch, dev)
    assert profiling.total("h2d.bytes") - before["h2d.bytes"] == sum(
        v.nbytes for v in batch.values())
    assert profiling.total("h2d.pageable_bytes") == \
        before["h2d.pageable_bytes"]


@pytest.mark.cuda
def test_decode_and_packing_never_wait_for_the_card():
    """The decode of nuScenes' six task groups and the packing of its
    result run under `set_sync_debug_mode("error")`; only the one
    readback waits, and it gives the per-array reads' dicts."""
    dev = card()
    rng = np.random.default_rng(9)
    logits = [torch.from_numpy(rng.normal(size=(900, w)).astype(
        np.float32)).to(dev).bfloat16() for w in NUSC_TASK_WIDTHS]
    codes = [torch.from_numpy(rng.normal(size=(900, 10)).astype(
        np.float32)).to(dev).bfloat16() for _ in NUSC_TASK_WIDTHS]
    centre = (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0)
    decode_boxes(logits, codes, post_center_range=centre)  # constants made
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dec = decode_boxes(logits, codes, post_center_range=centre)
        packed = formats.pack_decoded(dec)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert packed.is_cuda and packed.shape == (300, 12)
    names = [f"c{i}" for i in range(10)]
    got = formats.decoded_to_eval_boxes(dec, names, 1)
    assert got == per_array(dec, names, 1)
    assert 0 < len(got) <= 300
