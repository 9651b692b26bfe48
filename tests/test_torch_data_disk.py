"""The port's on-disk data path against the JAX package's, on the CPU: the
synthetic raw archive, the PCD readers, the converters and GT database, the
datasets, CBGS and the train / test loaders.

One raw archive is built by each package from the same seeds (the JAX
package's with JPEG cameras, the port's with `.npy` ones). Both packages
convert the JAX archive, whose JPEGs both decode with Pillow, and their
loaders run over their own conversions. Everything is bit-equal except the
loaders' images, which go through the bilinear resize: those are held to
the resize tolerance of tests/test_torch_data_pipelines.py over the
normalisation's std.
"""
import filecmp
import itertools
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from cmtcoop_tpu.configs import presets as jpresets
from cmtcoop_tpu.data import datasets as jdatasets
from cmtcoop_tpu.data import loader as jloader
from cmtcoop_tpu.data import synthetic_archive as jarchive
from cmtcoop_tpu.data.converters import a9_nusc as ja9_nusc
from cmtcoop_tpu.data.converters import a9coop as ja9coop
from cmtcoop_tpu.data.converters import pcd as jpcd
from cmtcoop_tpu_torch.configs import presets
from cmtcoop_tpu_torch.data import datasets, loader, synthetic_archive
from cmtcoop_tpu_torch.data.converters import a9_nusc, a9coop, pcd
from tests.test_torch_data_pipelines import assert_resized_close, assert_same

ARCHIVE = dict(n_obj=4, n_ground=300, pts_per_obj=40)
# (split, frames, seed, camera size): the training split's cameras at the
# TUMTraf Basler cameras' size, where the calibrations project the objects
# (the GT database's image patches); the val split's small
SPLITS = (("train", 3, 0, (1200, 1920)), ("val", 3, 1, (32, 64)))
IMAGE_KEYS = ("vehicle_imgs", "infrastructure_imgs")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """PyTorch on one intra-op thread here: the suite runs several test
    processes side by side on the host's cores, and the loader's worker
    threads call into PyTorch too, so more threads only oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def preset_of(mod):
    """The small fusion detector's preset on the cooperative infos: the
    archive's four classes, its range, 64x128 camera crops."""
    names = ("CAR", "TRUCK", "VAN", "PEDESTRIAN")
    return mod.tiny_preset(**dict(
        presets.SMALL_FUSION_PRESET, ann_prefix="a9_nusc_coop_infos",
        class_names=names, tasks=(names,), pc_range=(-48, -48, -8, 48, 48, 0),
        ida_final_dim=(64, 128), ida_resize_lim=(0.08, 0.1), max_gt=16,
        max_points=2048))


def relative(obj, roots):
    """`obj` with every string that starts with one of `roots` cut to the
    path below it (the two conversions live in different directories)."""
    if isinstance(obj, dict):
        return {k: relative(v, roots) for k, v in obj.items()}
    if isinstance(obj, list):
        return [relative(v, roots) for v in obj]
    if isinstance(obj, tuple):
        return tuple(relative(v, roots) for v in obj)
    if isinstance(obj, str):
        for r in roots:
            if obj.startswith(r):
                return os.path.relpath(obj, r)
    return obj


def load_pkl(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """Both archives, both packages' conversions of the JAX archive (infos,
    GT database, image patches; the intersection layout too), the arrays
    the JAX archive encoded as JPEG."""
    root = tmp_path_factory.mktemp("disk")
    d = {k: str(root / k) for k in ("jraw", "raw", "jdata", "data",
                                    "jnusc", "nusc")}
    encoded = []
    from PIL import Image
    fromarray = Image.fromarray

    def record(arr, *args, **kwargs):
        encoded.append(np.array(arr))
        return fromarray(arr, *args, **kwargs)

    Image.fromarray = record
    try:
        for split, n, seed, hw in SPLITS:
            jarchive.build_raw_archive(d["jraw"], split, n, seed,
                                       img_hw=hw, **ARCHIVE)
    finally:
        Image.fromarray = fromarray
    for split, n, seed, hw in SPLITS:
        synthetic_archive.build_raw_archive(d["raw"], split, n, seed,
                                            img_hw=hw, **ARCHIVE)
    for mod, out in ((ja9coop, d["jdata"]), (a9coop, d["data"])):
        mod.convert_all(d["jraw"], out)
        mod.create_gt_database(out)
        mod.create_gt_database_images(out)
    # the intersection converter reads the infrastructure labels
    for split, *_ in SPLITS:
        lbl = os.path.join(d["jraw"], split, "labels_point_clouds")
        shutil.copytree(os.path.join(lbl, synthetic_archive.REG_DIR),
                        os.path.join(lbl, "s110_lidar_ouster_south"),
                        dirs_exist_ok=True)
    ja9_nusc.convert_all(d["jraw"], d["jnusc"])
    a9_nusc.convert_all(d["jraw"], d["nusc"])
    d["encoded"] = encoded
    return d


def files_under(root, sub):
    out = []
    for dirpath, _, names in os.walk(os.path.join(root, sub)):
        out += [os.path.relpath(os.path.join(dirpath, n), root)
                for n in names]
    return sorted(out)


def test_raw_archive_equals_jax(disk):
    """Clouds, labels and layout byte-equal; each `.npy` camera image the
    array the JAX archive encoded as JPEG."""
    for split, n, *_ in SPLITS:
        for sub in ("point_clouds", "labels_point_clouds"):
            ref = files_under(os.path.join(disk["jraw"], split), sub)
            if sub == "labels_point_clouds":  # the copy made for a9_nusc
                ref = [f for f in ref if "s110_lidar_ouster_south/" not in f]
            assert ref == files_under(os.path.join(disk["raw"], split), sub)
            assert len(ref) == (3 if sub == "point_clouds" else 1) * n
            for f in ref:
                assert filecmp.cmp(os.path.join(disk["jraw"], split, f),
                                   os.path.join(disk["raw"], split, f),
                                   shallow=False), f
    images = []
    for split, n, *_ in SPLITS:
        ref = files_under(os.path.join(disk["jraw"], split), "images")
        ours = files_under(os.path.join(disk["raw"], split), "images")
        assert [f[:-len(".jpg")] for f in ref] == [f[:-len(".npy")]
                                                   for f in ours]
        # the order the archive writes them: frame by frame, camera by camera
        def order(f):
            cam = f.split(os.sep)[1]  # images/<cam>/<ts>_<cam>.npy
            return (os.path.basename(f).split("_" + cam)[0],
                    synthetic_archive.CAMS.index(cam))

        ours.sort(key=order)
        images += [np.load(os.path.join(disk["raw"], split, f))
                   for f in ours]
    assert len(images) == len(disk["encoded"]) == 4 * 6
    assert_same(images, disk["encoded"])


def test_pcd_readers_equal_jax(disk):
    """`read_pcd` and `pcd_to_bin` over the archive's clouds, which take all
    three encodings, and the LZF decoder on streams with back-references."""
    clouds = files_under(os.path.join(disk["jraw"], "train"), "point_clouds")
    formats = set()
    for f in clouds:
        path = os.path.join(disk["jraw"], "train", f)
        with open(path, "rb") as fh:
            formats.add(fh.read(400).split(b"DATA ")[1].split()[0])
        assert_same(pcd.read_pcd(path), jpcd.read_pcd(path))
        ours = pcd.pcd_to_bin(path, os.path.join(disk["jraw"], "o.bin"))
        ref = jpcd.pcd_to_bin(path, os.path.join(disk["jraw"], "r.bin"))
        assert_same(ours, ref)
        assert filecmp.cmp(os.path.join(disk["jraw"], "o.bin"),
                           os.path.join(disk["jraw"], "r.bin"), shallow=False)
    assert formats == {b"ascii", b"binary", b"binary_compressed"}
    raw = np.random.default_rng(0).integers(0, 256, 100, np.uint8).tobytes()
    assert pcd.lzf_compress_literal(raw) == jpcd.lzf_compress_literal(raw)
    streams = ((bytes([0x02]) + b"abc" + bytes([(4 << 5), 0x02]), 9),
               (bytes([0x00]) + b"q" + bytes([(7 << 5), 0x03, 0x00]), 13))
    for stream, n in streams:
        assert pcd.lzf_decompress(stream, n) == jpcd.lzf_decompress(stream, n)
    with pytest.raises(ValueError):
        pcd.lzf_decompress(bytes([(4 << 5), 0x02]), 6)


@pytest.mark.parametrize("what", [
    "a9_nusc_coop_infos_train.pkl", "a9_nusc_coop_infos_val.pkl",
    "a9_nusc_coop_infos_test.pkl", "a9_nusc_coop_dbinfos_train.pkl",
    "a9_nusc_infos_train.pkl", "a9_nusc_infos_val.pkl"])
def test_converters_equal_jax(disk, what):
    """Infos, GT database (its clouds and image patches too) field by field,
    paths made relative to each conversion's directory."""
    ours_dir, ref_dir = ((disk["nusc"], disk["jnusc"])
                         if what.startswith("a9_nusc_infos")
                         else (disk["data"], disk["jdata"]))
    roots = (ours_dir, ref_dir, disk["jraw"])
    ours = load_pkl(os.path.join(ours_dir, what))
    ref = load_pkl(os.path.join(ref_dir, what))
    assert_same(relative(ours, roots), relative(ref, roots))
    if "dbinfos" in what:
        entries = [e for v in ref.values() for e in v]
        assert entries and any(e["cam_patches"] for e in entries)
        for sub in ("a9_nusc_coop_gt_database",
                    "a9_nusc_coop_gt_database_patches"):
            files = files_under(ref_dir, sub)
            assert files and files == files_under(ours_dir, sub)
            for f in files:
                assert filecmp.cmp(os.path.join(ours_dir, f),
                                   os.path.join(ref_dir, f), shallow=False)
    elif "test" not in what:
        assert len(ref["infos"]) == 3


def test_cbgs_indices_equal_jax(disk):
    ds = datasets.A9NuscCoopDataset(
        os.path.join(disk["data"], "a9_nusc_coop_infos_train.pkl"),
        presets.TUMTRAF_CLASSES)
    jds = jdatasets.A9NuscCoopDataset(
        os.path.join(disk["jdata"], "a9_nusc_coop_infos_train.pkl"),
        jpresets.TUMTRAF_CLASSES)
    for seed in range(3):
        ours = datasets.cbgs_indices(ds, np.random.default_rng(seed))
        ref = jdatasets.cbgs_indices(jds, np.random.default_rng(seed))
        assert len(ref) > len(ds)
        assert_same(ours, ref)


def assert_batch_close(ours, ref):
    """Every key bit-equal except the images: within the resize tolerance,
    one uint8 level being 1/std after the normalisation."""
    assert set(ours) == set(ref)
    scale = 1.0 / min(presets.tiny_preset().img_norm_std)
    for k in IMAGE_KEYS:
        assert ours[k].shape == ref[k].shape and ours[k].dtype == ref[k].dtype
        assert_resized_close(ours.pop(k), ref.pop(k), scale, k)
    assert_same(ours, ref)


def test_train_loader_equals_jax(disk):
    """The first 3 batches of `build_train_loader` (CBGS, GT paste from the
    dbinfos found beside the infos) against the JAX loader's."""
    kw = dict(batch_size=2, num_workers=2, seed=3)
    ours, spe = loader.build_train_loader(preset_of(presets), disk["data"],
                                          **kw)
    ref, jspe = jloader.build_train_loader(preset_of(jpresets),
                                           disk["jdata"], **kw)
    assert spe == jspe == len(ref.indices) // 2 >= 3
    assert ours.dataset.pipeline.db_sampler is not None
    assert_same(ours.indices, ref.indices)
    pasted = 0
    for a, b in itertools.islice(zip(ours.iter_steps(), ref.iter_steps()),
                                 3):
        pasted += int(b["gt_mask"].sum())
        assert_batch_close(a, b)
    # the GT paste added objects: more GT than the 4 boxes a frame holds
    assert pasted > 3 * 2 * 4


def test_test_loader_equals_jax(disk):
    """The 3 val batches of `build_test_loader` against the JAX loader's,
    and the datasets' GT in the scorer's layout."""
    ds, ours = loader.build_test_loader(preset_of(presets), disk["data"],
                                        batch_size=1, num_workers=2)
    jds, ref = jloader.build_test_loader(preset_of(jpresets), disk["jdata"],
                                         batch_size=1, num_workers=2)
    assert len(ds) == len(jds) == 3 and ds.test_mode
    batches = list(zip(ours, ref))
    assert len(batches) == 3
    for a, b in batches:
        assert not any(k.startswith("gt_") for k in a)
        assert_batch_close(a, b)
    assert_same([i["timestamp"] for i in ds.infos],
                [i["timestamp"] for i in jds.infos])
    assert_same(ds.gt_eval_boxes(), jds.gt_eval_boxes())


def test_resumed_stream_replays_the_uninterrupted_one(disk):
    """`iter_steps(start_step=2)` gives batches 2, 3, ... of the stream
    from step 0, across the epoch boundary."""
    ours, spe = loader.build_train_loader(preset_of(presets), disk["data"],
                                          batch_size=1, num_workers=2,
                                          use_cbgs=False)
    n = spe + 1
    full = list(itertools.islice(ours.iter_steps(max_epochs=2), n))
    resumed = list(itertools.islice(ours.iter_steps(start_step=2,
                                                    max_epochs=2), n - 2))
    assert len(full) == n and len(resumed) == n - 2
    assert_same(resumed, full[2:])
    assert not all(np.array_equal(a["vehicle_points"], b["vehicle_points"])
                   for a, b in zip(full, full[spe:]))  # epochs reshuffle


def test_spawned_workers_give_the_thread_stream(disk):
    """Process mode: the dataset, its `Pipeline` and GT sampler pickled to
    spawned workers, which give the thread mode's batches bit for bit."""
    streams = []
    for procs in (False, True):
        ours, _ = loader.build_train_loader(preset_of(presets), disk["data"],
                                            batch_size=1, num_workers=1,
                                            use_cbgs=False)
        ours.use_processes = procs
        it = ours.iter_steps(start_step=1)
        streams.append(list(itertools.islice(it, 2)))
        it.close()
    assert_same(streams[1], streams[0])
