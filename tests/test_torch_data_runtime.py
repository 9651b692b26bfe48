"""The port's host-side data and logging runtime on CPU, against the JAX
package.

- `synthetic_batch_iter` bit-equal to JAX's: the tiny preset's first 5
  batches (the pool cycled), the full `cmt_fusion_coop_tumtraf`'s first
  batch;
- `PrefetchLoader`: the per-epoch reshuffle and a mid-epoch resume give the
  JAX loader's index stream, and spawn process mode gives thread mode's
  (the counterparts of tests/test_schedule_resume.py's loader tests);
- `apply_overrides` gives field-equal presets to JAX's, and refuses the
  same unknown field;
- the TensorBoard writer's records read back with the JAX writer's tags,
  steps and values.
"""
import dataclasses
import itertools
import struct

import numpy as np
import pytest

from cmtcoop_tpu.configs import presets as jpresets
from cmtcoop_tpu.data.loader import PrefetchLoader as JPrefetchLoader
from cmtcoop_tpu.data.synthetic import \
    synthetic_batch_iter as jsynthetic_batch_iter
from cmtcoop_tpu.utils.config import apply_overrides as japply_overrides
from cmtcoop_tpu.utils.tb_writer import TensorBoardWriter as JWriter
from cmtcoop_tpu_torch.configs import presets
from cmtcoop_tpu_torch.data.loader import PrefetchLoader
from cmtcoop_tpu_torch.data.synthetic import synthetic_batch_iter
from cmtcoop_tpu_torch.utils.config import apply_overrides
from cmtcoop_tpu_torch.utils.tb_writer import TensorBoardWriter, _masked_crc
from tests.torch_loader_stub import StubDataset


def assert_batches_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("name,n_batches,kw", [
    ("cmt_lidar_vehicle_tiny", 5, {}),
    # one scene in the pool: the first batch is scene 0 either way, and the
    # full-width images and 300000-point clouds of three more are not drawn
    ("cmt_fusion_coop_tumtraf", 1, dict(n_scenes=1))])
def test_synthetic_stream_equals_the_jax_stream(name, n_batches, kw):
    ours = synthetic_batch_iter(presets.get_preset(name), 1, 3, **kw)
    ref = jsynthetic_batch_iter(jpresets.get_preset(name), 1, 3, **kw)
    for a, b in itertools.islice(zip(ours, ref), n_batches):
        assert_batches_equal(a, b)


def collect(it, n):
    out = [(int(b["idx"][0, 0]), int(b["epoch"][0, 0]))
           for b in itertools.islice(it, n)]
    it.close()
    return out


def test_loader_reshuffles_and_resumes_as_the_jax_loader():
    kw = dict(batch_size=1, num_workers=2, shuffle_seed=7)
    loader = PrefetchLoader(StubDataset(12), np.arange(12), **kw)
    ref = JPrefetchLoader(StubDataset(12), np.arange(12), **kw)
    for epoch in (0, 1, 5):
        assert np.array_equal(loader.epoch_indices(epoch),
                              ref.epoch_indices(epoch))
    full = collect(loader.iter_steps(0), 24)
    assert full == collect(ref.iter_steps(0), 24)
    assert full[:12] != full[12:]
    assert {e for _, e in full[:12]} == {0}
    assert {e for _, e in full[12:]} == {1}
    for start in (5, 12, 17):
        assert collect(loader.iter_steps(start), 24 - start) == full[start:]


def test_spawned_workers_match_threads():
    kw = dict(batch_size=2, num_workers=2, shuffle_seed=7)
    threads = PrefetchLoader(StubDataset(12), np.arange(12), **kw)
    spawned = PrefetchLoader(StubDataset(12), np.arange(12),
                             use_processes=True, **kw)
    # one epoch boundary crossed: the workers see the new epoch
    assert collect(spawned.iter_steps(3), 5) == collect(
        threads.iter_steps(3), 5)
    with pytest.raises(ValueError):
        PrefetchLoader(StubDataset(4), np.arange(4), batch_size=3,
                       num_processes=2)


@pytest.mark.parametrize("overrides", [
    ["max_gt=64", "pc_range=(-50,-50,-5,50,50,3)"],
    ["tiny=True", "img_spec=V-19-slim-eSE", "dn_groups=2"], []])
def test_apply_overrides_equals_the_jax_overrides(overrides):
    name = "cmt_fusion_coop_tumtraf"
    ours = apply_overrides(presets.get_preset(name), overrides)
    ref = japply_overrides(jpresets.get_preset(name), overrides)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    with pytest.raises(KeyError):
        apply_overrides(ours, ["no_such_field=1"])


def read_events(path):
    """The (step, {tag: value}) of each scalar event, each record's CRCs
    checked; the first record's file version."""

    def varint(buf, i):
        n = shift = 0
        while True:
            b = buf[i]
            n |= (b & 0x7F) << shift
            i, shift = i + 1, shift + 7
            if not b & 0x80:
                return n, i

    def fields(buf):
        i, out = 0, []
        while i < len(buf):
            key, i = varint(buf, i)
            field, wire = key >> 3, key & 7
            if wire == 0:
                v, i = varint(buf, i)
            elif wire == 1:
                v, i = buf[i:i + 8], i + 8
            elif wire == 5:
                v, i = buf[i:i + 4], i + 4
            else:
                n, i = varint(buf, i)
                v, i = buf[i:i + n], i + n
            out.append((field, v))
        return out

    events, version = [], None
    with open(path, "rb") as f:
        while header := f.read(8):
            (length,) = struct.unpack("<Q", header)
            assert struct.unpack("<I", f.read(4))[0] == _masked_crc(header)
            data = f.read(length)
            assert struct.unpack("<I", f.read(4))[0] == _masked_crc(data)
            ev = dict(fields(data))
            if 3 in ev:
                version = ev[3].decode()
                continue
            scalars = {}
            for field, value in fields(ev[5]):
                v = dict(fields(value))
                scalars[v[1].decode()] = struct.unpack("<f", v[2])[0]
            events.append((ev[2], scalars))
    return version, events


def test_tb_writer_reads_back_as_the_jax_writer(tmp_path):
    logs = [(1, {"train/loss": 3.25, "train/grad_norm": 40.5}),
            (2, {"train/loss": 2.5, "train/lr": 1e-4, "skip": "text"}),
            (300, {"val/object/map": 0.125})]
    paths = []
    for cls, d in ((TensorBoardWriter, "p"), (JWriter, "j")):
        w = cls(str(tmp_path / d))
        for step, scalars in logs:
            w.add_scalars(step, scalars, wall_time=1.5)
        w.close()
        paths.append(w.path)
    ours, ref = read_events(paths[0]), read_events(paths[1])
    assert ours == ref and ours[0] == "brain.Event:2"
    assert [s for s, _ in ours[1]] == [1, 2, 300]
    assert ours[1][1][1] == {"train/loss": 2.5,
                             "train/lr": np.float32(1e-4)}


def test_profiling_helpers(tmp_path, monkeypatch):
    """`trace` exports a Chrome trace; `time_fn` refuses to time without a
    card."""
    import torch
    from cmtcoop_tpu_torch.utils import profiling
    with profiling.trace(str(tmp_path)):
        torch.ones(8).sum()
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert profiling.materialize({"a": [torch.ones(3)]}) == 3.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        profiling.time_fn(lambda: torch.ones(1))
