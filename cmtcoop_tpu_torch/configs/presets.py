"""Model presets: the TUMTraf operating points, the original CMT nuScenes
presets and the tiny smoke preset of cmtcoop_tpu/configs/presets.py, copied
so the port depends on no module of the JAX package.
tests/test_torch_weights.py holds every preset here equal to its JAX
counterpart, field by field.

Each preset is built from (domain, modality); the reference's mmcv configs
are projects/configs/CMTCoop_TUMTraf/{camera,lidar,fusion}/{vehicle,infra,
coop} and CMT_Nuscenes/{camera,lidar,fusion}.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

TUMTRAF_CLASSES = (
    "CAR", "TRAILER", "TRUCK", "VAN", "PEDESTRIAN", "BUS", "BICYCLE")
NUSCENES_CLASSES = (
    "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
    "motorcycle", "bicycle", "pedestrian", "traffic_cone")
NUSCENES_TASKS = (
    ("car",), ("truck", "construction_vehicle"), ("bus", "trailer"),
    ("barrier",), ("motorcycle", "bicycle"), ("pedestrian", "traffic_cone"))
# the decode's post-centre range (x, y, z low, then high; m) by dataset: the
# nuScenes configs' `post_center_range` (CMT_Nuscenes/fusion/
# cmt_voxel0075_vov_1600x640_cbgs.py), else the TUMTraf configs' +-80 m
POST_CENTER_RANGES = {"nuscenes": (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0)}
DEFAULT_POST_CENTER_RANGE = (-80.0, -80.0, -10.0, 80.0, 80.0, 10.0)


@dataclasses.dataclass
class Preset:
    name: str
    domain: str                 # vehicle | infrastructure | coop
    modality: str               # camera | lidar | fusion
    class_names: Tuple[str, ...]
    tasks: Tuple[Tuple[str, ...], ...]
    pc_range: Tuple[float, ...]
    voxel_size: Tuple[float, float, float]
    grid_size: Tuple[int, int, int]
    num_views: int              # cameras per agent
    img_size: Tuple[int, int]   # (H, W) after ida + pad
    max_points: int = 300000
    max_voxels_train: int = 120000
    max_voxels_eval: int = 160000
    max_gt: int = 128
    dn_groups: int = 5
    total_epochs: int = 20
    base_lr: float = 1e-4
    samples_per_gpu: int = 1
    # dataset
    dataset: str = "a9coop"     # a9coop | a9nusc | a9kitti | nuscenes
    ann_prefix: str = "a9_nusc_coop_infos"
    img_norm_mean: Tuple[float, float, float] = (103.530, 116.280, 123.675)
    img_norm_std: Tuple[float, float, float] = (57.375, 57.120, 58.395)
    ida_resize_lim: Tuple[float, float] = (0.94, 1.25)
    ida_final_dim: Tuple[int, int] = (640, 1600)
    # image backbone: "V-*" = VoVNet spec, "r{depth}" = ResNet
    img_spec: str = "V-99-eSE"
    img_out_features: Tuple[str, ...] = ("stage4", "stage5")
    tiny: bool = False

    @property
    def use_lidar(self) -> bool:
        return self.modality in ("lidar", "fusion")

    @property
    def use_camera(self) -> bool:
        return self.modality in ("camera", "fusion")

    @property
    def agents(self) -> Tuple[str, ...]:
        if self.domain == "coop":
            return ("vehicle", "infrastructure")
        return (self.domain,)

    def extractor_kwargs(self, train: bool = False) -> Dict[str, Any]:
        out = dict(
            voxel_size=self.voxel_size,
            pc_range=self.pc_range,
            grid_size=self.grid_size,
            max_voxels=(self.max_voxels_train if train
                        else self.max_voxels_eval),
            img_spec=self.img_spec,
            img_out_features=self.img_out_features,
        )
        if self.tiny:
            out.update(
                sparse_base_channels=8,
                sparse_channels=((8, 8, 8), (8, 8, 16), (16, 16, 16),
                                 (16, 16)),
                sparse_out_channels=16,
                sparse_stage_caps=(128,) * 4,
                pillar_caps=(128,) * 4,
                second_channels=(16, 32), second_layers=(1, 1),
                fpn_channels=(16, 16), img_spec="V-19-slim-eSE",
                neck_out_channels=32)
        return out

    def head_kwargs(self) -> Dict[str, Any]:
        out = dict(
            tasks=self.tasks,
            max_gt=self.max_gt,
            dn_groups=self.dn_groups,
        )
        if self.tiny:
            out.update(num_query=24, hidden_dim=32, in_channels=32,
                       depth_num=8, num_decoder_layers=2, num_heads=4,
                       feedforward_channels=64)
        return out


def tumtraf_preset(domain: str, modality: str, **over) -> Preset:
    """TUMTraf presets (coop config:1-30): pc [-72..72]x[-8..0] @ voxel
    (0.1, 0.1, 0.2) -> grid 1440x1440x40, ida final (640, 1600)."""
    base = dict(
        name=f"cmt_{modality}_{domain}_tumtraf",
        domain=domain, modality=modality,
        class_names=TUMTRAF_CLASSES, tasks=(TUMTRAF_CLASSES,),
        pc_range=(-72.0, -72.0, -8.0, 72.0, 72.0, 0.0),
        voxel_size=(0.1, 0.1, 0.2), grid_size=(1440, 1440, 40),
        num_views=1 if domain == "vehicle" else 3,
        img_size=(640, 1600),
        dataset="a9coop" if domain == "coop" else "a9nusc",
        ann_prefix=("a9_nusc_coop_infos" if domain == "coop"
                    else "a9_nusc_infos"),
    )
    base.update(over)
    return Preset(**base)


def nuscenes_preset(modality: str, **over) -> Preset:
    """Original CMT nuScenes presets (CMT_Nuscenes configs): pc
    [-54..54]x[-5..3] @ voxel 0.075 -> grid 1440x1440x40, 6 cams."""
    base = dict(
        name=f"cmt_{modality}_nuscenes",
        domain="vehicle", modality=modality,
        class_names=NUSCENES_CLASSES, tasks=NUSCENES_TASKS,
        pc_range=(-54.0, -54.0, -5.0, 54.0, 54.0, 3.0),
        voxel_size=(0.075, 0.075, 0.2), grid_size=(1440, 1440, 40),
        num_views=6, img_size=(640, 1600),
        dataset="nuscenes", ann_prefix="nuscenes_infos",
    )
    base.update(over)
    return Preset(**base)


def post_center_range(preset: Preset) -> Tuple[float, ...]:
    """The range a decoded box's centre must lie in (`decode_boxes`
    `post_center_range`), from the preset's dataset."""
    return POST_CENTER_RANGES.get(preset.dataset, DEFAULT_POST_CENTER_RANGE)


def tiny_preset(**over) -> Preset:
    """Miniature preset for smoke tests -- not a reference config."""
    base = dict(
        name="cmt_lidar_vehicle_tiny",
        domain="vehicle", modality="lidar",
        class_names=("CAR",), tasks=(("CAR",),),
        pc_range=(-8.0, -8.0, -5.0, 8.0, 8.0, 5.0),
        voxel_size=(1.0, 1.0, 0.25), grid_size=(16, 16, 40),
        num_views=1, img_size=(64, 128),
        max_points=1024, max_voxels_train=128, max_voxels_eval=128,
        max_gt=8, dn_groups=2, total_epochs=1,
        dataset="a9nusc", ann_prefix="a9_nusc_infos",
        tiny=True,
    )
    base.update(over)
    return Preset(**base)


def get_preset(name: str) -> Preset:
    return PRESETS[name]


PRESETS: Dict[str, Preset] = {
    p.name: p for p in [tumtraf_preset(dom, mod)
                        for dom in ("vehicle", "infrastructure", "coop")
                        for mod in ("camera", "lidar", "fusion")]
    + [nuscenes_preset(mod) for mod in ("camera", "lidar", "fusion")]
    # the reference's 4th nuScenes config, CMT_Nuscenes/fusion/
    # cmt_voxel0100_r50_800x320_cbgs.py: sparse_shape [41, 1024, 1024], not
    # ceil(108 / 0.1) = 1080, so the BEV map stays even through every
    # stride; its ResNet-50 is not ported, so it raises at build
    + [nuscenes_preset("fusion", name="cmt_fusion_r50_nuscenes",
                       voxel_size=(0.1, 0.1, 0.2), grid_size=(1024, 1024, 40),
                       img_size=(320, 800), ida_resize_lim=(0.47, 0.625),
                       ida_final_dim=(320, 800), img_spec="r50",
                       img_out_features=("layer3", "layer4"))]
    + [tiny_preset()]}

# The small cooperative LiDAR detector of the port's parity checks (the CPU
# tests against the JAX package, and the GPU-vs-CPU phase of chip_smoke.py):
# a 2-stage pillar encoder, a 16x16 BEV (256 memory tokens per agent) and 2
# decoder layers. `tiny_preset(**SMALL_COOP_PRESET)` is its preset.
SMALL_COOP_PRESET = dict(domain="coop", pc_range=(-16, -16, -5, 16, 16, 5),
                         voxel_size=(1, 1, 0.25), grid_size=(32, 32, 40))
SMALL_COOP_EXTRACTOR = dict(sparse_base_channels=8,
                            sparse_channels=((8, 16), (16,)),
                            sparse_out_channels=16, pillar_caps=(128, 128),
                            fpn_channels=(16, 16))
SMALL_COOP_HEAD = dict(downsample_scale=2)
# the same detector with the gather sparse encoder (`encoder_impl="gather"`,
# active sets capped at 128 after each downsample, as the tiny preset's)
SMALL_GATHER_EXTRACTOR = dict(SMALL_COOP_EXTRACTOR, encoder_impl="gather",
                              sparse_stage_caps=(128, 128))

# The small cooperative fusion detector: the same LiDAR branch, plus a
# V-19-slim-eSE backbone and a CPFPN of 32 channels (= hidden_dim, as the
# image tokens join the memory unprojected) on 64x128 images (4x8 tokens per
# view), depth_num 8 (the tiny head's). `tiny_preset(**SMALL_FUSION_PRESET)`
# is its preset; data/synthetic.py `small_fusion_batch()` its batch.
SMALL_FUSION_PRESET = dict(SMALL_COOP_PRESET, modality="fusion")
SMALL_FUSION_EXTRACTOR = SMALL_COOP_EXTRACTOR
SMALL_FUSION_HEAD = SMALL_COOP_HEAD
