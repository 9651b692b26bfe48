"""The port's host-side data pipeline against the JAX package's, on the CPU.

Every module of the pipeline is held bit-equal to its JAX counterpart on the
same seeded inputs and the same numpy generator state: box geometry,
loading utilities, every transform, the native geometry library and its
numpy route, the GT-database sampler and the composed pipelines. The one
exception is the bilinear image resize, which the port runs through
PyTorch's antialiased uint8 `interpolate` where the JAX package calls
Pillow: it is held to Pillow within RESIZE_LEVELS uint8 levels, with at
most RESIZE_SHARE of the values differing and at most RESIZE_SHARE_OVER_1
by more than one level.
"""
import copy
import pickle
import sys

import numpy as np
import pytest

from cmtcoop_tpu.configs import presets as jpresets
from cmtcoop_tpu.data import native as jnative
from cmtcoop_tpu.data import pipeline_builder as jbuilder
from cmtcoop_tpu.data.pipelines import box_np as jbox
from cmtcoop_tpu.data.pipelines import dbsampler as jdb
from cmtcoop_tpu.data.pipelines import loading_utils as jlu
from cmtcoop_tpu.data.pipelines import transforms as JT
from cmtcoop_tpu_torch.configs import presets
from cmtcoop_tpu_torch.data import native
from cmtcoop_tpu_torch.data import pipeline_builder as builder
from cmtcoop_tpu_torch.data.pipelines import box_np
from cmtcoop_tpu_torch.data.pipelines import dbsampler as db
from cmtcoop_tpu_torch.data.pipelines import loading_utils as lu
from cmtcoop_tpu_torch.data.pipelines import transforms as T

COOP = ("vehicle_", "infrastructure_")
# the resize against Pillow's BILINEAR: the largest difference in uint8
# levels, the share of values that may differ at all and the share that may
# differ by more than one level. PyTorch's uint8 antialiased bilinear keeps
# its weights in 16-bit fixed point where Pillow keeps 22 bits, and both
# round to uint8 between the horizontal and the vertical pass, so a value
# near a rounding tie may land one level off in each pass. On seeded uint8
# noise the 1200x1920 -> 1000x1600 downscale differs in 0.02% of the values,
# by 1; the 256x512 -> 800x1600 upscale in 1.9%, up to 5 of its 3.84
# million values by 2 (3 of 5 seeds); over upscales of 1.1x to 8x of four
# sizes the most was 4.9% (2.25x, where the ties recur every 4 pixels) and
# 0.014% by 2 (32x64 at 1.1x). After normalisation (std >= 57.12) two
# levels are <= 0.035
RESIZE_LEVELS = 2
RESIZE_SHARE = 0.05
RESIZE_SHARE_OVER_1 = 2e-4


def assert_same(a, b, path="sample"):
    """Bit-equal nested dicts / lists / arrays / scalars, dtypes included."""
    if isinstance(b, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in b:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), path
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def assert_resized_close(ours, ref, scale=1.0, what="image"):
    """Within RESIZE_LEVELS uint8 levels (times `scale`, the normalisation's
    1/std), at most RESIZE_SHARE of the values differing and at most
    RESIZE_SHARE_OVER_1 by more than one level."""
    diff = np.abs(np.asarray(ours, np.float64) - np.asarray(ref, np.float64))
    levels = diff / scale
    assert levels.max() <= RESIZE_LEVELS + 1e-3, (what, levels.max())
    assert (diff > 0).mean() <= RESIZE_SHARE, (what, (diff > 0).mean())
    assert (levels > 1 + 1e-3).mean() <= RESIZE_SHARE_OVER_1, (
        what, (levels > 1 + 1e-3).sum())


def coop_sample(rng, n=600, views=(1, 2), g=6, hw=(24, 40)):
    """A cooperative sample in the pipeline layout: clouds, images,
    cameras, boxes, labels and names."""
    sample = {}
    v2i = np.eye(4, dtype=np.float32)
    v2i[:3, :3] = jbox.rot_mat_z(0.35)
    v2i[:3, 3] = [5.0, -3.0, 0.2]
    sample["vehicle2infrastructure"] = v2i
    for p, v in zip(COOP, views):
        pts = rng.uniform(-60, 60, (n, 5)).astype(np.float32)
        pts[:, 2] = rng.uniform(-8, 0, n)
        sample[p + "points"] = pts
        sample[p + "img_list"] = [
            rng.integers(0, 256, (*hw, 3)).astype(np.float32)
            for _ in range(v)]
        l2c = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
        l2c[:, :3, 3] = rng.normal(size=(v, 3))
        intr = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
        intr[:, 0, 0] = intr[:, 1, 1] = 500.0
        intr[:, 0, 2], intr[:, 1, 2] = hw[1] / 2, hw[0] / 2
        sample[p + "lidar2cam"] = l2c
        sample[p + "cam_intrinsic"] = intr
        sample[p + "lidar2img"] = np.einsum("vij,vjk->vik", intr, l2c)
    boxes = np.zeros((g, 9), np.float32)
    boxes[:, :2] = rng.uniform(-80, 80, (g, 2))
    boxes[:, 2] = rng.uniform(-8, -2, g)
    boxes[:, 3:6] = rng.uniform(1, 4, (g, 3))
    boxes[:, 6] = rng.uniform(-4, 4, g)
    boxes[:, 7:] = rng.normal(size=(g, 2))
    sample["gt_boxes_3d"] = boxes
    sample["gt_labels_3d"] = rng.integers(0, 7, g).astype(np.int64)
    sample["gt_names"] = [presets.TUMTRAF_CLASSES[i] for i in
                          rng.integers(0, 7, g)]
    return sample


def rand_boxes(rng, n, width=7):
    b = np.zeros((n, width), np.float32)
    b[:, :2] = rng.uniform(-20, 20, (n, 2))
    b[:, 2] = rng.uniform(-3, 0, n)
    b[:, 3:6] = rng.uniform(0.5, 5, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    if width > 7:
        b[:, 7:] = rng.normal(size=(n, width - 7))
    return b


# ------------------------------------------------------------ box_np

BOX_CASES = {
    "rot_mat_z": lambda m, r: m.rot_mat_z(0.7),
    "rotate_points": lambda m, r: m.rotate_points(r["pts"], 0.4),
    "rotate_boxes": lambda m, r: m.rotate_boxes(r["boxes"], -1.1),
    "scale_points": lambda m, r: m.scale_points(r["pts"], 1.03),
    "scale_boxes": lambda m, r: m.scale_boxes(r["boxes"], 0.97),
    "translate_points": lambda m, r: m.translate_points(r["pts"],
                                                        (1.0, -2.0, 0.5)),
    "translate_boxes": lambda m, r: m.translate_boxes(r["boxes"],
                                                      (0.5, 0.25, -1.0)),
    "transform_points": lambda m, r: m.transform_points(r["pts"], r["mat"]),
    "corners_bev": lambda m, r: m.corners_bev(r["boxes"]),
    "points_in_rbbox": lambda m, r: m.points_in_rbbox(r["pts"], r["boxes"]),
    "points_in_rbbox_empty": lambda m, r: m.points_in_rbbox(
        r["pts"], r["boxes"][:0]),
    "box_collision_test": lambda m, r: m.box_collision_test(
        r["boxes"], r["other"]),
    "box_collision_test_empty": lambda m, r: m.box_collision_test(
        r["boxes"][:0], r["other"]),
}


def box_inputs(rng):
    mat = np.eye(4, dtype=np.float32)
    mat[:3, :3] = jbox.rot_mat_z(0.3)
    mat[:3, 3] = [1.0, 2.0, -0.5]
    return dict(pts=rng.uniform(-25, 25, (400, 5)).astype(np.float32),
                boxes=rand_boxes(rng, 12, 9), other=rand_boxes(rng, 9),
                mat=mat)


@pytest.mark.parametrize("case", sorted(BOX_CASES))
def test_box_np_equals_jax(rng, case):
    inputs = box_inputs(rng)
    ours = BOX_CASES[case](box_np, copy.deepcopy(inputs))
    ref = BOX_CASES[case](jbox, copy.deepcopy(inputs))
    assert_same(ours, ref)


def test_loading_utils_equal_jax(rng, tmp_path):
    pts = rng.uniform(-30, 30, (2000, 5)).astype(np.float32)
    pts[:, 2] = rng.uniform(-10, 5, 2000)
    for beams in (4, 8, 32):
        assert_same(lu.reduce_lidar_beams(pts, beams),
                    jlu.reduce_lidar_beams(pts, beams))
    path = str(tmp_path / "virtual.npy")
    np.save(path, dict(real_points=pts[:50], virtual_points=pts[50:80]),
            allow_pickle=True)
    for dims in (None, (0, 1, 2)):
        assert_same(lu.load_virtual_points(path, dims),
                    jlu.load_virtual_points(path, dims))


# ---------------------------------------------------------- transforms

TRANSFORMS = {
    "vehicle_points_to_infra": lambda m, s, r: m.vehicle_points_to_infra(s),
    "transform_lidar2img_to_infra":
        lambda m, s, r: m.transform_lidar2img_to_infra(s),
    "points_range_filter": lambda m, s, r: m.points_range_filter(
        s, (-50, -40, -6, 50, 40, -1), prefixes=COOP),
    "object_range_filter": lambda m, s, r: m.object_range_filter(
        s, (-50, -40, -6, 50, 40, -1)),
    "object_name_filter": lambda m, s, r: m.object_name_filter(
        s, ("CAR", "VAN", "BUS")),
    "point_shuffle": lambda m, s, r: m.point_shuffle(s, r, prefixes=COOP),
    "global_rot_scale_trans": lambda m, s, r: m.global_rot_scale_trans(
        s, r, translation_std=(0.5, 0.2, 0.1), prefixes=COOP),
    "modal_mask": lambda m, s, r: [m.modal_mask(s, r, prefixes=COOP)
                                   for _ in range(6)][-1],
    "normalize_images": lambda m, s, r: m.normalize_images(
        s, (103.53, 116.28, 123.675), (57.375, 57.12, 58.395),
        prefixes=COOP),
    "normalize_images_rgb": lambda m, s, r: m.normalize_images(
        s, (1.0, 2.0, 3.0), (2.0, 3.0, 4.0), to_rgb=True, prefixes=COOP),
    "pad_images": lambda m, s, r: m.pad_images(s, 32, prefixes=COOP),
    "random_flip_3d": lambda m, s, r: [m.random_flip_3d(s, r, prefixes=COOP)
                                       for _ in range(4)][-1],
    "global_rot_scale_trans_image":
        lambda m, s, r: m.global_rot_scale_trans_image(s, r, prefixes=COOP),
    "limit_period": lambda m, s, r: m.limit_period(
        s["gt_boxes_3d"][:, 6], 0.5, np.pi),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_equals_jax(rng, name):
    """The same seeded sample and generator through each transform of both
    packages: equal outputs and equal generator states after."""
    sample = coop_sample(rng)
    r_ours, r_ref = np.random.default_rng(7), np.random.default_rng(7)
    ours = TRANSFORMS[name](T, copy.deepcopy(sample), r_ours)
    ref = TRANSFORMS[name](JT, copy.deepcopy(sample), r_ref)
    assert_same(ours, ref)
    assert r_ours.integers(1 << 62) == r_ref.integers(1 << 62)


def test_point_loaders_equal_jax(rng, tmp_path):
    pts = rng.normal(size=(300, 5)).astype(np.float32)
    pts.tofile(tmp_path / "a.bin")
    np.save(tmp_path / "a.npy", pts)
    for f in ("a.bin", "a.npy"):
        for use_dim in ((0, 1, 2, 3, 4), (0, 1, 2)):
            assert_same(T.load_points_bin(str(tmp_path / f), 5, use_dim),
                        JT.load_points_bin(str(tmp_path / f), 5, use_dim))
    sweeps = []
    for i in range(4):
        path = str(tmp_path / f"s{i}.bin")
        rng.normal(size=(50 + i, 5)).astype(np.float32).tofile(path)
        sweeps.append(dict(
            data_path=path, timestamp=1000.0 * i,
            sensor2lidar_rotation=jbox.rot_mat_z(0.1 * i),
            sensor2lidar_translation=rng.normal(size=3)))
    for sweeps_num, test_mode in ((10, False), (2, False), (2, True)):
        r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
        assert_same(T.load_multi_sweeps(pts, sweeps, r1, sweeps_num,
                                        test_mode=test_mode),
                    JT.load_multi_sweeps(pts, sweeps, r2, sweeps_num,
                                         test_mode=test_mode))


@pytest.mark.parametrize("src_hw,dst_hw", [
    ((1200, 1920), (1000, 1600)),   # TUMTraf's cameras to the width 1600
    ((256, 512), (800, 1600)),      # the synthetic archive's, upscaled
    ((301, 517), (455, 777)),       # odd sizes
])
def test_resize_close_to_pillow(src_hw, dst_hw):
    """`_resize_bilinear` against the JAX package's Pillow BILINEAR resize
    of the same clipped uint8 image (seeded noise, the hardest case)."""
    img = np.random.default_rng(0).integers(
        0, 256, (*src_hw, 3)).astype(np.float32)
    ours = T._resize_bilinear(img, dst_hw[::-1])
    ref = JT._resize_bilinear(img, dst_hw[::-1])
    assert ours.shape == ref.shape == (*dst_hw, 3)
    assert ours.dtype == ref.dtype == np.float32
    assert_resized_close(ours, ref)


@pytest.mark.parametrize("training", [True, False])
def test_resize_crop_flip_image_equals_jax(rng, training):
    """The image-domain aug: cameras bit-equal, images within the resize's
    tolerance, generator states equal."""
    sample = coop_sample(rng, hw=(60, 100))
    conf = dict(resize_lim=(1.3, 1.6), final_dim=(64, 128),
                bot_pct_lim=(0.0, 0.1), rot_lim=(0.0, 0.0), H=60, W=100,
                rand_flip=True)
    r_ours, r_ref = np.random.default_rng(5), np.random.default_rng(5)
    ours = T.resize_crop_flip_image(copy.deepcopy(sample), r_ours, conf,
                                    training, prefixes=COOP)
    ref = JT.resize_crop_flip_image(copy.deepcopy(sample), r_ref, conf,
                                    training, prefixes=COOP)
    for p in COOP:
        for a, b in zip(ours.pop(p + "img_list"), ref.pop(p + "img_list")):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert_resized_close(a, b)
    assert_same(ours, ref)
    assert r_ours.integers(1 << 62) == r_ref.integers(1 << 62)


def test_load_image_npy_and_jpeg(rng, tmp_path):
    from PIL import Image
    img = rng.integers(0, 256, (20, 30, 3)).astype(np.uint8)
    np.save(tmp_path / "a.npy", img)
    got = T.load_image(str(tmp_path / "a.npy"))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, img.astype(np.float32))
    Image.fromarray(img).save(tmp_path / "a.jpg")
    Image.fromarray(img[..., 0]).save(tmp_path / "g.png")  # grey -> RGB
    for name in ("a.jpg", "g.png"):
        assert_same(T.load_image(str(tmp_path / name)),
                    JT.load_image(str(tmp_path / name)))


def test_load_image_raises_without_pillow(rng, tmp_path, monkeypatch):
    img = rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)
    np.save(tmp_path / "a.npy", img)
    (tmp_path / "a.jpg").write_bytes(b"not decoded")
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.delitem(sys.modules, "PIL.Image", raising=False)
    # .npy needs no decoder
    np.testing.assert_array_equal(T.load_image(str(tmp_path / "a.npy")), img)
    with pytest.raises(ImportError, match="a.jpg.*Pillow"):
        T.load_image(str(tmp_path / "a.jpg"))


# ------------------------------------------------------------- native

NATIVE = {
    "points_in_rbbox": lambda m, r: m.points_in_rbbox(r["pts"], r["boxes"]),
    "box_collision_test": lambda m, r: m.box_collision_test(r["boxes"],
                                                            r["other"]),
    "remove_points_in_boxes": lambda m, r: m.remove_points_in_boxes(
        r["pts"], r["boxes"]),
    "remove_points_no_box": lambda m, r: m.remove_points_in_boxes(
        r["pts"], r["boxes"][:0]),
}


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("name", sorted(NATIVE))
def test_native_routes_equal_jax(rng, monkeypatch, route, name):
    """Both routes of the port's `native` (the library, and the numpy path a
    host without it takes) against the JAX package's `native`."""
    if route == "native":
        assert native.loaded(), "native/libcmtcoop_host.so did not load"
    else:
        monkeypatch.setattr(native, "_load", lambda: None)
        assert not native.loaded()
    inputs = box_inputs(rng)
    assert_same(NATIVE[name](native, copy.deepcopy(inputs)),
                NATIVE[name](jnative, copy.deepcopy(inputs)))


# ---------------------------------------------------------- dbsampler

def write_database(rng, root, patches=False):
    """A GT database of 3 classes under `root`: per-object clouds
    recentred at the box origin, its dbinfos pkl, and optionally per-camera
    image patches (`cam_patches`)."""
    infos = {}
    for ci, cls in enumerate(("CAR", "TRUCK", "PEDESTRIAN")):
        for i in range(5 + ci):
            box = rand_boxes(rng, 1)[0] * np.float32(1.5)
            box[2] = -5.0
            n = int(rng.integers(2, 40))
            path = f"db/{cls}_{i}.bin"
            (root / "db").mkdir(exist_ok=True)
            rng.normal(size=(n, 5)).astype(np.float32).tofile(root / path)
            entry = dict(name=cls, path=path, gt_idx=i, box3d_lidar=box,
                         num_points_in_gt=n, difficulty=int(i == 4),
                         load_dim=5)
            if patches:
                entry["cam_patches"] = {}
                for tag in ("vehicle_cam0", "infrastructure_cam1"):
                    ppath = str(root / "db" / f"{cls}_{i}_{tag}.npy")
                    np.save(ppath, rng.uniform(
                        0, 255, (int(rng.integers(40, 120)),
                                 int(rng.integers(40, 120)), 3)
                    ).astype(np.float32))
                    entry["cam_patches"][tag] = dict(path=ppath)
            infos.setdefault(cls, []).append(entry)
    with open(root / "dbinfos.pkl", "wb") as f:
        pickle.dump(infos, f)
    return dict(info_path=str(root / "dbinfos.pkl"), data_root=str(root),
                sample_groups=dict(CAR=4, TRUCK=3, PEDESTRIAN=6),
                classes=("CAR", "TRUCK", "PEDESTRIAN"),
                filter_by_min_points=dict(CAR=5, TRUCK=5, PEDESTRIAN=5),
                filter_by_difficulty=(1,))


def test_dbsampler_equals_jax(rng, tmp_path):
    cfg = write_database(rng, tmp_path)
    ours, ref = db.DataBaseSampler(**cfg), jdb.DataBaseSampler(**cfg)
    assert_same(ours.db_infos, ref.db_infos)
    gt = rand_boxes(rng, 3)
    for seed in range(3):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        got = ours.sample_all(gt, ["CAR", "PEDESTRIAN", "CAR"], r1)
        want = ref.sample_all(gt, ["CAR", "PEDESTRIAN", "CAR"], r2)
        assert len(want["gt_names"]) > 0
        assert_same(got, want)
        assert r1.integers(1 << 62) == r2.integers(1 << 62)


@pytest.mark.parametrize("sample_2d", [False, True])
def test_unified_object_sample_equals_jax(rng, tmp_path, sample_2d):
    cfg = write_database(rng, tmp_path, patches=sample_2d)
    names = ("CAR", "TRUCK", "PEDESTRIAN")
    sample = coop_sample(rng, g=3, hw=(300, 400))
    sample["gt_labels_3d"] = np.array([0, 2, 1], np.int64)
    sample["gt_names"] = ["CAR", "PEDESTRIAN", "TRUCK"]
    # cameras that see the pasted objects (the patch path pastes only what
    # projects in front of a camera)
    for p in COOP:
        sample[p + "lidar2img"][:, 2] = [0.0, 0.0, 0.0, 50.0]
    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    got = db.unified_object_sample(
        copy.deepcopy(sample), db.DataBaseSampler(**cfg), r1, names,
        prefixes=COOP, sample_2d=sample_2d)
    want = jdb.unified_object_sample(
        copy.deepcopy(sample), jdb.DataBaseSampler(**cfg), r2, names,
        prefixes=COOP, sample_2d=sample_2d)
    assert len(want["gt_names"]) > 3
    if sample_2d:
        assert any(not np.array_equal(a, b) for a, b in zip(
            want["vehicle_img_list"], sample["vehicle_img_list"]))
    assert_same(got, want)


# ------------------------------------------------------------ pipeline

def pipeline_preset(mod, modality):
    return mod.tiny_preset(domain="coop", modality=modality,
                           class_names=("CAR", "TRUCK", "PEDESTRIAN"),
                           tasks=(("CAR", "TRUCK", "PEDESTRIAN"),),
                           pc_range=(-60, -60, -8, 60, 60, 0),
                           ida_final_dim=(64, 128),
                           ida_resize_lim=(0.1, 0.12))


@pytest.mark.parametrize("training", [True, False])
def test_lidar_pipeline_equals_jax(rng, tmp_path, training):
    """The composed LiDAR pipeline (GT paste in training) bit-equal to the
    JAX closure on the same sample and generator."""
    cfg = write_database(rng, tmp_path)
    sample = coop_sample(rng, g=3)
    sample["gt_labels_3d"] = np.array([0, 2, 1], np.int64)
    sample["gt_names"] = ["CAR", "PEDESTRIAN", "TRUCK"]
    for p in COOP:
        del sample[p + "img_list"]
    ours = builder.build_pipeline(
        pipeline_preset(presets, "lidar"), training, COOP,
        db_sampler=db.DataBaseSampler(**cfg))
    ref = jbuilder.build_pipeline(
        pipeline_preset(jpresets, "lidar"), training, COOP,
        db_sampler=jdb.DataBaseSampler(**cfg))
    r1, r2 = np.random.default_rng(2), np.random.default_rng(2)
    assert_same(ours(copy.deepcopy(sample), r1),
                ref(copy.deepcopy(sample), r2))


def test_built_pipeline_pickles(rng, tmp_path):
    """`build_pipeline` returns an object the spawned loader workers can
    take: unpickled, it gives the same sample (fusion, GT paste on)."""
    cfg = write_database(rng, tmp_path)
    pipe = builder.build_pipeline(
        pipeline_preset(presets, "fusion"), True, COOP,
        db_sampler=db.DataBaseSampler(**cfg), modal_mask=True)
    clone = pickle.loads(pickle.dumps(pipe))
    assert isinstance(clone, builder.Pipeline)
    sample = coop_sample(rng, g=3, hw=(90, 160))
    sample["gt_labels_3d"] = np.array([0, 2, 1], np.int64)
    sample["gt_names"] = ["CAR", "PEDESTRIAN", "TRUCK"]
    for seed in range(3):
        out = pipe(copy.deepcopy(sample), np.random.default_rng(seed))
        assert_same(clone(copy.deepcopy(sample),
                          np.random.default_rng(seed)), out)
    assert out["vehicle_imgs"].shape == (1, 64, 128, 3)
