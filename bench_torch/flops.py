"""The analytic count of a frame's model operations, from a configuration's
widths and the frame's active voxels per level of the sparse encoder.

It counts what the reference computes as convolutions and matrix products
(two operations a multiply-add), so it equals PyTorch's `FlopCounterMode`
over the reference's forward: every conv at its output size, a sparse conv
as its active output sites times its kernel's taps (a missing neighbour's
zero tap included), the decoder's projections and both products of each
attention, the MLPs of the position encodings, the last decoder layer's
task heads. Elementwise work, norms, softmax and pooling are not counted.
"""
from __future__ import annotations

from typing import Dict, List


def _conv(h: int, w: int, cin: int, cout: int, k: int) -> int:
    return 2 * h * w * cin * cout * k * k


def _out(d: int, k: int, s: int, p: int, ceil: bool = False) -> int:
    if ceil:
        return -(-(d + 2 * p - k) // s) + 1
    return (d + 2 * p - k) // s + 1


def vovnet(cam: dict, h: int, w: int) -> int:
    """One view's VoVNet and CPFPN level-0 operations."""
    stem = cam["stem"]
    total, cin = 0, 3
    for cout, s in zip(stem, (2, 1, 2)):
        h, w = _out(h, 3, s, 1), _out(w, 3, s, 1)
        total += _conv(h, w, cin, cout, 3)
        cin = cout
    sizes = {}
    for i in range(4):
        if i:
            h, w = _out(h, 3, 2, 0, True), _out(w, 3, 2, 0, True)
        ch, out_ch = cam["stage_conv_ch"][i], cam["stage_out_ch"][i]
        for _ in range(cam["block_per_stage"][i]):
            c = cin
            for _ in range(cam["layer_per_block"]):
                total += _conv(h, w, c, ch, 3)
                c = ch
            total += _conv(h, w, cin + cam["layer_per_block"] * ch, out_ch,
                           1)
            total += 2 * out_ch * out_ch  # eSE
            cin = out_ch
        sizes[f"stage{i + 2}"] = (h, w, cin)
    n = cam["neck_out_channels"]
    for name in cam["out_features"]:
        fh, fw, c = sizes[name]
        total += _conv(fh, fw, c, n, 1)
    fh, fw, _ = sizes[cam["out_features"][0]]
    return total + _conv(fh, fw, n, n, 3)


def feature_hw(cam: dict, h: int, w: int):
    """The CPFPN level-0 map's (H, W) for (h, w) images."""
    for s in (2, 1, 2):
        h, w = _out(h, 3, s, 1), _out(w, 3, s, 1)
    stage = int(cam["out_features"][0][-1])
    for _ in range(stage - 2):
        h, w = _out(h, 3, 2, 0, True), _out(w, 3, 2, 0, True)
    return h, w


def lidar(li: dict, counts: Dict[str, list]) -> int:
    """One cloud's sparse encoder, SECOND and FPN operations, from its
    active voxels at each level (`voxels`) and `conv_out`'s sites."""
    vox = counts["voxels"]
    total = 2 * vox[0] * 27 * li["in_channels"] * li["base_channels"]
    stages = li["encoder_channels"]
    cin = li["base_channels"]
    for i, blocks in enumerate(stages):
        last = i == len(stages) - 1
        n_sbb = len(blocks) - (0 if last else 1)
        c = blocks[0]
        total += n_sbb * 2 * (2 * vox[i] * 27 * c * c)
        if not last:
            total += 2 * vox[i + 1] * 27 * c * blocks[-1]
        cin = blocks[-1]
    out = li["output_channels"]
    total += 2 * counts["conv_out"] * 3 * cin * out
    gx, gy, gz = li["grid_size"]
    d, h, w = gz + 1, gy, gx
    for zp in li["down_z_pads"][:len(stages) - 1]:
        d, h, w = _out(d, 3, 2, zp), _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    d = _out(d, 3, 2, 0)
    c = out * d
    outs = []
    for cout, n, s in zip(li["second_channels"], li["second_layers"],
                          li["second_strides"]):
        h, w = _out(h, 3, s, 1), _out(w, 3, s, 1)
        total += _conv(h, w, c, cout, 3) + n * _conv(h, w, cout, cout, 3)
        c = cout
        outs.append((h, w, cout))
    for (oh, ow, cin), cout, s in zip(outs, li["fpn_channels"],
                                      li["fpn_strides"]):
        total += _conv(oh, ow, cin, cout, s)  # 1x1, or k = s transposed
    return total


def head(cfg: dict, n_image_tokens: List[int], views: List[int],
         bev_tokens: int) -> int:
    """The head's operations for the agents' image tokens and views."""
    hd = cfg["head"]
    c, f, q = hd["hidden_dim"], hd["feedforward_channels"], hd["num_query"]
    dn = hd["depth_num"]
    mlp_bev = 2 * (2 * c * c + c * c)
    mlp_rv = 2 * (3 * dn * 4 * c + 4 * c * c)
    total = q * mlp_bev  # the queries' BEV position encoding
    for n_img, v in zip(n_image_tokens, views):
        total += 2 * bev_tokens * hd["in_channels"] * c * 9  # shared_conv
        total += bev_tokens * mlp_bev
        nk = bev_tokens + n_img
        if n_img:
            total += 2 * n_img * dn * 4 * 4 + n_img * mlp_rv  # rv pe
            total += 2 * v * q * 4 * 4 + 2 * v * q * dn * 4 * 4  # rays
            total += v * q * mlp_rv
        layer = (3 * 2 * q * c * c + 2 * 2 * q * q * c + 2 * q * c * c
                 + 2 * q * c * c + 2 * 2 * nk * c * c + 2 * 2 * q * nk * c
                 + 2 * q * c * c + 2 * 2 * q * c * f)
        total += hd["num_decoder_layers"] * layer
    hc = hd["head_conv"]
    for task in hd["tasks"]:
        for dim in (2, 1, 3, 2, 2, len(task)):
            total += 2 * q * c * hc + 2 * q * hc * dim
    return total


def frame_flops(cfg: dict, counts: Dict[str, Dict[str, list]]) -> int:
    """One frame's operations; `counts[agent]` its cloud's active sets
    (the reference's `active_counts`)."""
    li, hd = cfg["lidar"], cfg["head"]
    total = sum(lidar(li, counts[a]) for a in cfg["agents"])
    bev = (li["grid_size"][1] // hd["downsample_scale"]) * \
        (li["grid_size"][0] // hd["downsample_scale"])
    views = [cfg["views"][a] for a in cfg["agents"]]
    n_img = [0] * len(views)
    cam = cfg.get("camera")
    if cam:
        h, w = cfg["image_hw"]
        fh, fw = feature_hw(cam, h, w)
        total += sum(v * vovnet(cam, h, w) for v in views)
        n_img = [v * fh * fw for v in views]
    return total + head(cfg, n_img, views, bev)
