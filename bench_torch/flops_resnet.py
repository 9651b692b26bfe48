"""The analytic count of a frame's operations for a configuration whose
camera branch is a ResNet (reference_resnet.py), by flops.py's
conventions: every conv at its output size, two operations a
multiply-add; the LiDAR branch and the head from flops.py."""
from __future__ import annotations

from typing import Dict, List

from bench_torch import flops
from bench_torch.flops import _conv, _out


def _stem_hw(h: int, w: int):
    """After the 7x7 stride-2 conv and the stride-2 max pool."""
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    return _out(h, 3, 2, 1), _out(w, 3, 2, 1)


def resnet(cam: dict, h: int, w: int) -> int:
    """One view's ResNet and CPFPN level-0 operations."""
    total = _conv(_out(h, 7, 2, 3), _out(w, 7, 2, 3), 3,
                  cam["base_channels"], 7)
    h, w = _stem_hw(h, w)
    cin, sizes = cam["base_channels"], {}
    for s, blocks in enumerate(cam["stage_blocks"]):
        planes = cam["base_channels"] * 2 ** s
        cout = planes * cam["expansion"]
        for b in range(blocks):
            stride = 2 if s > 0 and b == 0 else 1
            oh, ow = _out(h, 3, stride, 1), _out(w, 3, stride, 1)
            total += (_conv(h, w, cin, planes, 1)
                      + _conv(oh, ow, planes, planes, 3)
                      + _conv(oh, ow, planes, cout, 1))
            if stride != 1 or cin != cout:
                total += _conv(oh, ow, cin, cout, 1)
            h, w, cin = oh, ow, cout
        sizes[f"layer{s + 1}"] = (h, w, cin)
    n = cam["neck_out_channels"]
    for name in cam["out_features"]:
        fh, fw, c = sizes[name]
        total += _conv(fh, fw, c, n, 1)
    fh, fw, _ = sizes[cam["out_features"][0]]
    return total + _conv(fh, fw, n, n, 3)


def feature_hw(cam: dict, h: int, w: int):
    """The CPFPN level-0 map's (H, W) for (h, w) images."""
    h, w = _stem_hw(h, w)
    for _ in range(int(cam["out_features"][0][-1]) - 1):
        h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    return h, w


def frame_flops(cfg: dict, counts: Dict[str, Dict[str, list]]) -> int:
    """One frame's operations (flops.frame_flops with the ResNet camera
    branch); `counts[agent]` its cloud's active sets."""
    li, hd, cam = cfg["lidar"], cfg["head"], cfg["camera"]
    total = sum(flops.lidar(li, counts[a]) for a in cfg["agents"])
    bev = (li["grid_size"][1] // hd["downsample_scale"]) * \
        (li["grid_size"][0] // hd["downsample_scale"])
    views: List[int] = [cfg["views"][a] for a in cfg["agents"]]
    h, w = cfg["image_hw"]
    fh, fw = feature_hw(cam, h, w)
    total += sum(v * resnet(cam, h, w) for v in views)
    return total + flops.head(cfg, [v * fh * fw for v in views], views, bev)
