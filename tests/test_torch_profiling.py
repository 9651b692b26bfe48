"""The port's spans and counters (utils/profiling.py) on the CPU: a span
enters `record_function` only while a profiler records, the stage clock's
ring keeps the last calls only, the traced book holds the latest profiling
session, and the counters in `to_device` and the pillar encoder count what
they should (torch and the port only, no jax)."""

import numpy as np
import pytest
import torch

from cmtcoop_tpu_torch.configs.presets import (SMALL_COOP_EXTRACTOR,
                                               SMALL_COOP_HEAD,
                                               SMALL_COOP_PRESET, tiny_preset)
from cmtcoop_tpu_torch.data.synthetic import small_coop_batch
from cmtcoop_tpu_torch.models.build import build_detector, random_init_
from cmtcoop_tpu_torch.train.eval_hook import to_device
from cmtcoop_tpu_torch.utils import profiling
from cmtcoop_tpu_torch.utils.profiling import Recorder

CPU = [torch.profiler.ProfilerActivity.CPU]


def _profile(schedule=None):
    return torch.profiler.profile(activities=CPU, schedule=schedule)


def test_no_record_function_while_no_profiler_records(monkeypatch):
    """Outside a profiler and in a schedule's warm-up step a span enters
    no `record_function`; in the active steps it enters one a call."""
    prof_mod = torch.autograd.profiler
    real, entered = prof_mod.record_function, []

    def recording(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(prof_mod, "record_function", recording)
    rec = Recorder()
    with rec.span("a"):
        with rec.span("b"):
            pass
    assert entered == []
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with _profile(sched) as prof:
        for step in range(2):
            with rec.span(f"step{step}"):
                pass
            prof.step()
    assert [n for n in entered if n.startswith("step")] == ["step1"]
    assert rec.traced_calls("step1") == 1 and rec.traced_calls("step0") == 0
    assert rec.host_ms("step0") is not None and rec.host_ms("step1") is None


def test_stage_clock_keeps_the_last_ring_of_calls():
    """With a patched clock: 3 warm-up calls of 1 ms, then 4 of 10 ns, in
    a ring of 4: the mean is the 4 last calls'. Calls while a profiler
    records go to the traced book, not the ring. A call inside another
    of `outside` counts 0, so summed names read their union."""
    ticks = []

    def clock():
        return ticks.pop(0)

    rec = Recorder(ring=4, clock=clock)
    for d in [1_000_000] * 3 + [10] * 4:
        ticks += [0, d]
        with rec.span("stage"):
            pass
    assert rec.host_ms("stage") == 1e-5
    with _profile():
        ticks += [0, 5_000_000]
        with rec.span("stage"):
            pass
    assert rec.host_ms("stage") == 1e-5
    assert rec.traced_calls("stage") == 1
    # the 2 newest calls before the newest 1; more calls than the ring
    # holds read None, not the mean of what is left
    ticks += [0, 1000]
    with rec.span("stage"):
        pass
    assert rec.host_ms("stage", calls=2, skip=1) == 1e-5
    assert rec.host_ms("stage", calls=2) == pytest.approx(5.05e-4)
    assert rec.host_ms("stage", calls=3, skip=1) == 1e-5
    assert rec.host_ms("stage", calls=4, skip=1) is None
    assert rec.host_ms("stage", calls=9, skip=2) is None
    assert rec.host_ms("stage", calls=0) is None
    # an outer span of 100 ns around an inner one of 40 ns
    ticks += [0, 30, 70, 100]
    with rec.span("outer"):
        with rec.span("inner"):
            pass
    assert rec.host_ms("inner") == 4e-5
    assert rec.host_ms("inner", outside=("outer", "inner")) == 0.0
    assert rec.host_ms("outer", outside=("outer", "inner")) == 1e-4
    # the default clock: the same object serves every call of a name
    assert profiling.span("x") is profiling.span("x")


def test_traced_book_holds_the_latest_session():
    rec = Recorder()
    for n_calls in (3, 2):
        with _profile():
            for _ in range(n_calls):
                with rec.span("s"):
                    pass
                rec.count("n", 7)
        with rec.span("between"):
            pass
    assert rec.traced_calls("s") == 2
    assert rec.traced_values("n") == [7, 7]
    assert rec.total("n") == 35
    rec.reset()
    assert rec.traced_calls("s") == 0 and rec.total("n") == 0
    assert rec.host_ms("between") is None


def test_to_device_counts_the_bytes_it_copies_from_the_host():
    batch = {"points": np.ones((1, 64, 5), np.float32),
             "points_mask": np.ones((1, 64), bool),
             "imgs": np.zeros((1, 2, 8, 16, 3), np.float32)}
    nbytes = sum(v.nbytes for v in batch.values())
    before = {k: profiling.total(k)
              for k in ("h2d.bytes", "h2d.pageable_bytes")}
    out = to_device(batch, torch.device("meta"))
    assert {k: v.device.type for k, v in out.items()} == dict.fromkeys(
        batch, "meta")
    assert profiling.total("h2d.bytes") - before["h2d.bytes"] == nbytes
    # numpy arrays are pageable memory
    assert (profiling.total("h2d.pageable_bytes")
            - before["h2d.pageable_bytes"]) == nbytes
    to_device(batch, "cpu")  # no copy leaves the host
    assert profiling.total("h2d.bytes") - before["h2d.bytes"] == nbytes


def test_device_scalars_are_kept_only_while_a_profiler_records():
    """A tensor counted outside a profiler is dropped (no sync, nothing
    kept); counted while one records it is kept as the tensor and read on
    the host only by the reader, after the frames."""
    rec = Recorder()
    kept = torch.tensor(3)
    rec.count("n", torch.tensor(99))
    assert rec.traced_values("n") == [] and rec.total("n") == 0
    with _profile():
        rec.count("n", kept)
        rec.count("n", torch.tensor([4]))
        kept.add_(2)  # a later write shows: the tensor is read at the end
    assert rec.traced_values("n") == [5, 4]
    assert rec.total("n") == 0


def test_pillar_counts_are_the_uncapped_counts():
    """`pillars.l0` .. `pillars.l<n-1>` hold each level's active BEV cells
    before its cap: with caps set below a cloud's counts the readings stay
    the counts, above the caps."""
    batch = {k: torch.from_numpy(v) for k, v in small_coop_batch().items()}

    def levels(caps):
        ek = dict(SMALL_COOP_EXTRACTOR, pillar_caps=caps)
        model = build_detector(tiny_preset(**SMALL_COOP_PRESET),
                               extractor_kwargs=ek,
                               head_kwargs=SMALL_COOP_HEAD)
        random_init_(model, torch.Generator().manual_seed(2))
        profiling.reset()  # no span ran since the last session
        with torch.inference_mode(), _profile():
            model(batch)
        n = len(SMALL_COOP_EXTRACTOR["sparse_channels"])
        return [profiling.traced_values(f"pillars.l{k}") for k in range(n)]

    full = levels((4096, 4096))
    assert all(len(v) == 2 and min(v) > 8 for v in full)  # two agents
    for k in range(len(full)):
        caps = [4096] * len(full)
        caps[k] = min(full[k]) - 3
        got = levels(tuple(caps))
        assert got[k] == full[k] and min(got[k]) > caps[k]


def test_voxel_count_is_the_uncapped_count():
    """`voxels.raw` holds each cloud's occupied voxels before `max_voxels`
    (the pillarize telemetry's `n_voxels_raw`): with the cap below a
    cloud's count the reading stays the count, above the cap, and nothing
    is counted while no profiler records."""
    batch = {k: torch.from_numpy(v) for k, v in small_coop_batch().items()}
    pts, mask = batch["vehicle_points"][0], batch["vehicle_points_mask"][0]

    def counted(max_voxels):
        ek = dict(SMALL_COOP_EXTRACTOR, max_voxels=max_voxels)
        model = build_detector(tiny_preset(**SMALL_COOP_PRESET),
                               extractor_kwargs=ek,
                               head_kwargs=SMALL_COOP_HEAD)
        random_init_(model, torch.Generator().manual_seed(2))
        profiling.reset()
        with torch.inference_mode():
            model(batch)
            assert profiling.traced_values("voxels.raw") == []
            with _profile():
                model(batch)
        stats = model.vehicle_model.pillarize(pts, mask,
                                              return_stats=True)[-1]
        return profiling.traced_values("voxels.raw"), stats

    full, stats = counted(4096)
    assert len(full) == 2 and full[0] == int(stats["n_voxels_raw"]) > 8
    capped, stats = counted(full[0] - 5)
    assert capped == full
    assert int(stats["n_voxels_dropped"]) == 5
