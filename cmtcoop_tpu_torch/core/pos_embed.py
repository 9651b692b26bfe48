"""Sin/cos position encodings and the camera-frustum grids of the RV
position encoding (counterpart of cmtcoop_tpu/core/pos_embed.py)."""
from __future__ import annotations

import math

import torch


def _dim_t(num_pos_feats: int, device) -> torch.Tensor:
    d = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    return 2.0 * torch.floor(d / 2.0) / num_pos_feats + 1.0


def _embed(p: torch.Tensor, dim_t: torch.Tensor) -> torch.Tensor:
    v = p[..., None] / dim_t
    return torch.stack([torch.sin(v[..., 0::2]), torch.cos(v[..., 1::2])],
                       dim=-1).reshape(*v.shape[:-1], -1)


def pos2embed(pos: torch.Tensor, num_pos_feats: int = 128) -> torch.Tensor:
    """(..., 2+) positions in [0, 1] -> (..., 2*num_pos_feats):
    concat(embed(y), embed(x)) with the linear divisor 2*(i//2)/npf + 1."""
    pos = pos * (2.0 * math.pi)
    dim_t = _dim_t(num_pos_feats, pos.device)
    return torch.cat([_embed(pos[..., 1], dim_t), _embed(pos[..., 0], dim_t)],
                     dim=-1)


def bev_grid_coords(grid_size_xy, downsample_scale: int,
                    device=None) -> torch.Tensor:
    """(y_size*x_size, 2) normalized cell centers (x, y), row-major (y, x)."""
    x_size = grid_size_xy[1] // downsample_scale
    y_size = grid_size_xy[0] // downsample_scale
    xs = (torch.arange(x_size, dtype=torch.float32, device=device) + 0.5) \
        / x_size
    ys = (torch.arange(y_size, dtype=torch.float32, device=device) + 0.5) \
        / y_size
    gx = xs[None, :].expand(y_size, x_size)
    gy = ys[:, None].expand(y_size, x_size)
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def bev_pos2embed_grid(grid_size_xy, downsample_scale: int,
                       num_pos_feats: int = 128, device=None) -> torch.Tensor:
    """pos2embed(bev_grid_coords(...)) computed separably: H + W sin/cos
    rows broadcast over the grid."""
    x_size = grid_size_xy[1] // downsample_scale
    y_size = grid_size_xy[0] // downsample_scale
    scale = 2.0 * math.pi
    xs = (torch.arange(x_size, dtype=torch.float32, device=device) + 0.5) \
        / x_size * scale
    ys = (torch.arange(y_size, dtype=torch.float32, device=device) + 0.5) \
        / y_size * scale
    dim_t = _dim_t(num_pos_feats, device)
    e_y = _embed(ys, dim_t)
    e_x = _embed(xs, dim_t)
    table = torch.cat([
        e_y[:, None, :].expand(y_size, x_size, num_pos_feats),
        e_x[None, :, :].expand(y_size, x_size, num_pos_feats)], dim=-1)
    return table.reshape(y_size * x_size, 2 * num_pos_feats)


def depth_bins(depth_num: int, max_range: float, device=None) -> torch.Tensor:
    """The shared depth-bin ladder 1 + d * (max_range - 1) / depth_num."""
    return 1.0 + torch.arange(depth_num, dtype=torch.float32,
                              device=device) * (max_range - 1.0) / depth_num


def frustum_coords(feat_hw, pad_hw, depth_num: int, max_range: float,
                   device=None) -> torch.Tensor:
    """(H, W, D, 4) homogeneous frustum samples (u*d, v*d, d, 1) for the RV
    position encoding: (u, v) the feature cells' pixel positions scaled to
    the padded image, d the depth bins."""
    h, w = feat_hw
    pad_h, pad_w = pad_hw
    coords_h = torch.arange(h, dtype=torch.float32, device=device) \
        * pad_h / h
    coords_w = torch.arange(w, dtype=torch.float32, device=device) \
        * pad_w / w
    dd = depth_bins(depth_num, max_range, device)[None, None, :].expand(
        h, w, depth_num)
    hh = coords_h[:, None, None].expand(h, w, depth_num)
    ww = coords_w[None, :, None].expand(h, w, depth_num)
    return torch.stack([ww * dd, hh * dd, dd, torch.ones_like(dd)], dim=-1)
