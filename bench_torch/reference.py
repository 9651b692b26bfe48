"""The plain reference: the cooperative CMT detector's eval forward and its
top-k decode in plain PyTorch, float32, from a configuration file's widths
and a dict of weights keyed by the reference model's (mmdet3d) state names.

It imports nothing of the program. Its sparse encoder is the textbook
rulebook convolution over the active voxel set (every tap a lookup of the
neighbour's coordinate in the sorted active keys, then one matrix product),
not the program's pillar layout; its image, BEV and decoder layers are
plain `F.conv2d`, `F.linear` and softmax attention.

`precision="fp8"` computes the same graph with every operand of every
convolution and matrix product rounded to float8 e4m3 (a per-tensor scale
at the tensor's largest magnitude), float32 accumulation and each product's
result stored in bfloat16, as the program stores its own: the control that
the comparison must refuse, the configuration's bfloat16 with its products
taken one precision step below.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # float8 e4m3's largest finite value


class Sparse(NamedTuple):
    coords: torch.Tensor   # (M, 3) int64 (z, y, x), sorted by key
    keys: torch.Tensor     # (M,) int64 linear ids, ascending
    feats: torch.Tensor    # (M, C) float32
    shape: Tuple[int, int, int]  # (D, H, W)


class RefOutput(NamedTuple):
    """One frame's reference answer: per query its box (x, y, z at the box
    centre, w, l, h, yaw, vx, vy) and per (query, class) its score; the
    decode's top-k scores, highest first."""
    boxes: np.ndarray       # (Q, 9)
    scores: np.ndarray      # (Q, classes)
    top_scores: np.ndarray  # (k,)


@contextlib.contextmanager
def full_float32():
    """float32 products in float32: TF32 off in cuBLAS and in cuDNN (whose
    default lets convolutions take TF32) while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _linear_key(coords: torch.Tensor, shape) -> torch.Tensor:
    _, h, w = shape
    return (coords[:, 0] * h + coords[:, 1]) * w + coords[:, 2]


class Reference:
    """The detector of `config` on the weights `params` (float32 tensors on
    one device, keyed by state name)."""

    def __init__(self, config: dict, params: Dict[str, torch.Tensor],
                 precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision must be float32 or fp8, got "
                             f"{precision!r}")
        self.cfg = config
        self.p = params
        self.fp8 = precision == "fp8"

    # -- operands -----------------------------------------------------------
    def _q(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def _o(self, y: torch.Tensor) -> torch.Tensor:
        """A product's result as the control stores it (bfloat16)."""
        return y.to(torch.bfloat16).float() if self.fp8 else y

    def conv2d(self, x, w, b=None, stride=1, pad=0):
        return self._o(F.conv2d(self._q(x), self._q(w), b, stride, pad))

    def linear(self, x, name: str):
        return self._o(F.linear(self._q(x),
                                self._q(self.p[name + ".weight"]),
                                self.p[name + ".bias"]))

    def bn(self, x, name: str, eps: float, channel_dim: int = 1):
        p = self.p
        scale = p[name + ".weight"] * torch.rsqrt(p[name + ".running_var"]
                                                  + eps)
        shift = p[name + ".bias"] - p[name + ".running_mean"] * scale
        shape = [1] * x.dim()
        shape[channel_dim] = -1
        return x * scale.view(shape) + shift.view(shape)

    def mlp(self, x, name: str):
        return self.linear(torch.relu(self.linear(x, name + ".0")),
                           name + ".2")

    def attention(self, q, k, v, heads: int):
        """Softmax attention of (N, C) projections, `heads` heads."""
        n, c = q.shape
        dh = c // heads
        qh = q.view(n, heads, dh).transpose(0, 1)
        kh = k.view(-1, heads, dh).transpose(0, 1)
        vh = v.view(-1, heads, dh).transpose(0, 1)
        logits = torch.matmul(self._q(qh), self._q(kh).transpose(1, 2))
        probs = torch.softmax(logits / math.sqrt(dh), dim=-1)
        out = self._o(torch.matmul(self._q(probs), self._q(vh)))
        return out.transpose(0, 1).reshape(n, c)

    # -- camera branch -----------------------------------------------------
    def vovnet(self, x, prefix: str) -> Dict[str, torch.Tensor]:
        cam = self.cfg["camera"]
        eps = cam["bn_eps"]

        def unit(x, name, stride=1, pad=1):
            y = self.conv2d(x, self.p[name + "/conv.weight"], None, stride,
                            pad)
            return torch.relu(self.bn(y, name + "/norm", eps))

        for i, stride in enumerate((2, 1, 2)):
            x = unit(x, f"{prefix}.stem.stem_{i + 1}", stride)
        out = {}
        for i in range(4):
            s = i + 2
            if i:
                x = F.max_pool2d(x, 3, 2, ceil_mode=True)
            for b in range(cam["block_per_stage"][i]):
                name = f"{prefix}.stage{s}.OSA{s}_{b + 1}"
                tag = f"OSA{s}_{b + 1}"
                parts = [x]
                for j in range(cam["layer_per_block"]):
                    parts.append(unit(parts[-1],
                                      f"{name}.layers.{j}.{tag}_{j}"))
                agg = unit(torch.cat(parts, 1),
                           f"{name}.concat.{tag}_concat", pad=0)
                fc_w = self.p[f"{name}.ese.fc.weight"][:, :, 0, 0]
                att = agg.mean(dim=(2, 3)) @ fc_w.t() + \
                    self.p[f"{name}.ese.fc.bias"]
                att = torch.clamp(att + 3.0, 0.0, 6.0) / 6.0
                y = agg * att[:, :, None, None]
                x = y + x if b > 0 else y
            if f"stage{s}" in cam["out_features"]:
                out[f"stage{s}"] = x
        return out

    def image_tokens(self, imgs, prefix: str):
        """(V, H, W, 3) images -> (V, Hf, Wf, C) CPFPN level 0."""
        x = imgs.permute(0, 3, 1, 2)
        feats = self.vovnet(x, f"{prefix}.img_backbone")
        names = self.cfg["camera"]["out_features"]
        lat = [self.conv2d(feats[n],
                           self.p[f"{prefix}.img_neck.lateral_convs.{i}"
                                  ".conv.weight"],
                           self.p[f"{prefix}.img_neck.lateral_convs.{i}"
                                  ".conv.bias"])
               for i, n in enumerate(names)]
        for i in range(len(lat) - 1, 0, -1):
            fine = lat[i - 1]
            up = F.interpolate(lat[i], scale_factor=2, mode="nearest")
            lat[i - 1] = fine + up[:, :, :fine.shape[2], :fine.shape[3]]
        f0 = self.conv2d(lat[0],
                         self.p[f"{prefix}.img_neck.fpn_convs.0.conv.weight"],
                         self.p[f"{prefix}.img_neck.fpn_convs.0.conv.bias"],
                         pad=1)
        return f0.permute(0, 2, 3, 1)

    # -- LiDAR branch ------------------------------------------------------
    def voxelize(self, points, mask) -> Sparse:
        """Points (N, F) -> the active voxels, each the mean of the first
        `max_points_per_voxel` of its points in cloud order."""
        li = self.cfg["lidar"]
        dev = points.device
        vs = torch.tensor(li["voxel_size"], device=dev)
        lo = torch.tensor(li["pc_range"][:3], device=dev)
        gx, gy, gz = li["grid_size"]
        shape = (gz + 1, gy, gx)
        g = torch.floor((points[:, :3] - lo) / vs).long()
        ok = mask & (g >= 0).all(1) & (g < torch.tensor([gx, gy, gz],
                                                        device=dev)).all(1)
        idx = torch.nonzero(ok)[:, 0]
        coords = g[idx].flip(1)  # (z, y, x)
        key = _linear_key(coords, shape)
        skey, order = torch.sort(key, stable=True)
        pts = points[idx][order]
        first = torch.ones(1, dtype=torch.bool, device=dev)
        head = torch.cat([first, skey[1:] != skey[:-1]])
        run = torch.cumsum(head.long(), 0) - 1
        ar = torch.arange(len(skey), device=dev)
        start = torch.cummax(torch.where(head, ar, 0), 0).values
        take = (ar - start) < li["max_points_per_voxel"]
        n_vox = int(head.sum())
        sums = torch.zeros(n_vox, pts.shape[1], device=dev)
        sums.index_add_(0, run[take], pts[take])
        counts = torch.zeros(n_vox, device=dev)
        counts.index_add_(0, run[take], torch.ones_like(run[take],
                                                        dtype=torch.float32))
        keys = skey[head]
        return Sparse(coords[order][head], keys, sums / counts[:, None],
                      shape)

    @staticmethod
    def out_set(coords: torch.Tensor, shape, ks, stride, pad):
        """The output sites of a SparseConv3d: every site that a tap
        reaches from an input site. Returns (coords, keys, shape)."""
        dev = coords.device
        st = torch.tensor(stride, device=dev)
        pd = torch.tensor(pad, device=dev)
        taps = torch.stack(torch.meshgrid(
            *[torch.arange(k, device=dev) for k in ks], indexing="ij"),
            -1).reshape(-1, 3)
        out_shape = tuple((d + 2 * p - k) // s + 1 for d, p, k, s in
                          zip(shape, pad, ks, stride))
        od = torch.tensor(out_shape, device=dev)
        o = coords[:, None, :] + pd - taps[None]
        ok = ((o % st) == 0).all(-1) & (o >= 0).all(-1) & \
            ((o // st) < od).all(-1)
        keys = torch.unique(_linear_key((o // st)[ok], out_shape))
        h, w = out_shape[1], out_shape[2]
        out = torch.stack([keys // (h * w), (keys // w) % h, keys % w], -1)
        return out, keys, out_shape

    def sparse_conv(self, x: Sparse, w: torch.Tensor,
                    stride: Sequence[int], pad: Sequence[int],
                    subm: bool) -> Sparse:
        """spconv's SubMConv3d (`subm`: outputs at the input sites) or
        SparseConv3d (outputs wherever a tap reaches an input site), with
        the weight in (O, kz, ky, kx, I) layout: each output site gathers
        its taps' inputs (zero where no site) and takes one product."""
        dev = x.feats.device
        ks = tuple(w.shape[1:4])
        st = torch.tensor(stride, device=dev)
        pd = torch.tensor(pad, device=dev)
        in_dims = torch.tensor(x.shape, device=dev)
        taps = torch.stack(torch.meshgrid(
            *[torch.arange(k, device=dev) for k in ks], indexing="ij"),
            -1).reshape(-1, 3)
        if subm:
            out_shape, coords, keys = x.shape, x.coords, x.keys
        else:
            coords, keys, out_shape = self.out_set(x.coords, x.shape, ks,
                                                   stride, pad)
        src = coords[:, None, :] * st - pd + taps[None]
        inside = (src >= 0).all(-1) & (src < in_dims).all(-1)
        skey = _linear_key(src.reshape(-1, 3), x.shape).view(src.shape[:2])
        pos = torch.searchsorted(x.keys, skey).clamp(max=len(x.keys) - 1)
        found = inside & (x.keys[pos] == skey)
        gathered = x.feats[pos] * found[..., None]
        kmat = w.permute(1, 2, 3, 4, 0).reshape(-1, w.shape[0])
        feats = self._o(self._q(gathered.reshape(len(keys), -1))
                        @ self._q(kmat))
        return Sparse(coords, keys, feats, out_shape)

    def _bn_sparse(self, x: Sparse, feats, name, relu=True):
        y = self.bn(feats, name, self.cfg["lidar"]["bn_eps"], 1)
        return x._replace(feats=torch.relu(y) if relu else y)

    def encoder(self, vox: Sparse, prefix: str) -> torch.Tensor:
        """Active voxels -> the dense (1, C*D', H', W') BEV map, channel
        c*D' + d (spconv's dense view)."""
        li = self.cfg["lidar"]
        p = f"{prefix}.pts_middle_encoder"

        def conv_bn(x, name, stride=(1, 1, 1), pad=(1, 1, 1), subm=True,
                    relu=True):
            y = self.sparse_conv(x, self.p[name + ".0.weight"], stride, pad,
                                 subm)
            return self._bn_sparse(y, y.feats, name + ".1", relu)

        x = conv_bn(vox, f"{p}.conv_input")
        stages = li["encoder_channels"]
        for i, blocks in enumerate(stages):
            last = i == len(stages) - 1
            n_sbb = len(blocks) - (0 if last else 1)
            for j in range(n_sbb):
                b = f"{p}.encoder_layers.encoder_layer{i + 1}.{j}"
                y = self.sparse_conv(x, self.p[b + ".conv1.weight"],
                                     (1, 1, 1), (1, 1, 1), True)
                y = self._bn_sparse(y, y.feats, b + ".norm1")
                y = self.sparse_conv(y, self.p[b + ".conv2.weight"],
                                     (1, 1, 1), (1, 1, 1), True)
                z = self.bn(y.feats, b + ".norm2", li["bn_eps"], 1)
                x = y._replace(feats=torch.relu(z + x.feats))
            if not last:
                zp = li["down_z_pads"][i]
                x = conv_bn(x, f"{p}.encoder_layers.encoder_layer{i + 1}."
                            f"{n_sbb}", (2, 2, 2), (zp, 1, 1), subm=False)
        x = conv_bn(x, f"{p}.conv_out", (2, 1, 1), (0, 0, 0), subm=False)
        d, h, w = x.shape
        c = x.feats.shape[1]
        dense = x.feats.new_zeros(d * h * w, c)
        dense[x.keys] = x.feats
        dense = dense.view(d, h, w, c).permute(3, 0, 1, 2)
        return dense.reshape(1, c * d, h, w)

    def active_counts(self, points, mask) -> Dict[str, list]:
        """The sparse encoder's active sets of one cloud, without features:
        `voxels` at each level, `pillars` (active BEV cells) at each level,
        and `conv_out`'s output sites."""
        li = self.cfg["lidar"]
        vox = self.voxelize(points, mask)
        coords, keys, shape = vox.coords, vox.keys, vox.shape
        voxels, pillars = [], []
        for i in range(len(li["encoder_channels"])):
            voxels.append(len(keys))
            pillars.append(int(torch.unique(keys % (shape[1] * shape[2]))
                               .numel()))
            if i < len(li["encoder_channels"]) - 1:
                coords, keys, shape = self.out_set(
                    coords, shape, (3, 3, 3), (2, 2, 2),
                    (li["down_z_pads"][i], 1, 1))
        _, keys, _ = self.out_set(coords, shape, (3, 1, 1), (2, 1, 1),
                                  (0, 0, 0))
        return dict(voxels=voxels, pillars=pillars, conv_out=len(keys))

    def bev_tokens(self, points, mask, prefix: str):
        """One cloud -> its (1, H', W', C) BEV feature map."""
        li = self.cfg["lidar"]
        x = self.encoder(self.voxelize(points, mask), prefix)
        outs = []
        for i, (n, s) in enumerate(zip(li["second_layers"],
                                       li["second_strides"])):
            for j in range(n + 1):
                name = f"{prefix}.pts_backbone.blocks.{i}.{3 * j}"
                x = self.conv2d(x, self.p[name + ".weight"], None,
                                s if j == 0 else 1, 1)
                x = torch.relu(self.bn(
                    x, f"{prefix}.pts_backbone.blocks.{i}.{3 * j + 1}",
                    li["bn_eps"]))
            outs.append(x)
        ups = []
        for i, (x, s) in enumerate(zip(outs, li["fpn_strides"])):
            w = self.p[f"{prefix}.pts_neck.deblocks.{i}.0.weight"]
            if s > 1:
                y = self._o(F.conv_transpose2d(self._q(x), self._q(w), None,
                                               s))
            else:
                y = self.conv2d(x, w)
            ups.append(torch.relu(self.bn(
                y, f"{prefix}.pts_neck.deblocks.{i}.1", li["bn_eps"])))
        return torch.cat(ups, 1).permute(0, 2, 3, 1)

    # -- head --------------------------------------------------------------
    @staticmethod
    def _embed(p, npf: int):
        i = torch.arange(npf, dtype=torch.float32, device=p.device)
        dim_t = 2.0 * torch.floor(i / 2.0) / npf + 1.0
        v = p[..., None] / dim_t
        return torch.stack([torch.sin(v[..., 0::2]), torch.cos(v[..., 1::2])],
                           -1).reshape(*v.shape[:-1], -1)

    def pos2embed(self, pos, npf: int):
        pos = pos * (2.0 * math.pi)
        return torch.cat([self._embed(pos[..., 1], npf),
                          self._embed(pos[..., 0], npf)], -1)

    def _norm01(self, xyz):
        r = self.cfg["lidar"]["pc_range"]
        lo = torch.tensor(r[:3], device=xyz.device)
        hi = torch.tensor(r[3:], device=xyz.device)
        return (xyz - lo) / (hi - lo)

    def _depths(self, dev):
        hd = self.cfg["head"]
        n = hd["depth_num"]
        top = self.cfg["lidar"]["pc_range"][3]
        return 1.0 + torch.arange(n, dtype=torch.float32,
                                  device=dev) * (top - 1.0) / n

    def rv_pe(self, feat_hw, pad_hw, img2lidar):
        """(V, Hf, Wf, C) PE of the image tokens."""
        h, w = feat_hw
        dev = img2lidar.device
        d = self._depths(dev)
        u = torch.arange(w, dtype=torch.float32, device=dev) * pad_hw[1] / w
        v = torch.arange(h, dtype=torch.float32, device=dev) * pad_hw[0] / h
        uu = u[None, :, None].expand(h, w, len(d))
        vv = v[:, None, None].expand(h, w, len(d))
        dd = d[None, None, :].expand(h, w, len(d))
        fr = torch.stack([uu * dd, vv * dd, dd, torch.ones_like(dd)], -1)
        pts = torch.einsum("hwdo,vco->vhwdc", fr, img2lidar)
        flat = self._norm01(pts[..., :3]).reshape(*pts.shape[:3], -1)
        return self.mlp(flat, "pts_bbox_head.rv_embedding")

    def rv_query_embed(self, ref01, lidar2img, img2lidar, pad_hw):
        r = self.cfg["lidar"]["pc_range"]
        lo = torch.tensor(r[:3], device=ref01.device)
        hi = torch.tensor(r[3:], device=ref01.device)
        pts = ref01 * (hi - lo) + lo
        pts_h = torch.cat([pts, torch.ones_like(pts[:, :1])], -1)
        proj = torch.einsum("nd,vcd->vnc", pts_h, lidar2img)
        z = proj[..., 2:3]
        uvz = torch.cat([proj[..., :3] / (z + torch.where(z > 0, 1e-6,
                                                          -1e-6)),
                         proj[..., 3:]], -1)
        u, v = uvz[..., 0], uvz[..., 1]
        seen = (u >= 0) & (u < pad_hw[1]) & (v >= 0) & (v < pad_hw[0]) & \
            (z[..., 0] > 0)
        ray = uvz[..., None, :3] * self._depths(ref01.device)[:, None]
        ray = torch.cat([ray, torch.ones_like(ray[..., :1])], -1)
        back = torch.einsum("vndo,vco->vndc", ray, img2lidar)
        flat = self._norm01(back[..., :3]).reshape(*back.shape[:2], -1)
        emb = self.mlp(flat, "pts_bbox_head.rv_embedding")
        return (emb * seen[..., None]).sum(0)

    def decoder(self, memory, memory_pos, query_pos):
        hd = self.cfg["head"]
        c, heads, eps = hd["hidden_dim"], hd["num_heads"], hd["ln_eps"]
        p = self.p
        pre = "pts_bbox_head.transformer.decoder"
        mem_pe = memory + memory_pos
        query = torch.zeros_like(query_pos)

        def ln(x, name):
            return F.layer_norm(x, (c,), p[name + ".weight"],
                                p[name + ".bias"], eps)

        for layer in range(hd["num_decoder_layers"]):
            lp = f"{pre}.layers.{layer}"
            a0 = f"{lp}.attentions.0.attn"
            w, b = p[a0 + ".in_proj_weight"], p[a0 + ".in_proj_bias"]
            q = query + query_pos
            qkv = [self._o(F.linear(self._q(x),
                                    self._q(w[i * c:(i + 1) * c]),
                                    b[i * c:(i + 1) * c]))
                   for i, x in enumerate((q, q, query))]
            out = self.linear(self.attention(*qkv, heads), a0 + ".out_proj")
            query = ln(query + out, f"{lp}.norms.0")
            a1 = f"{lp}.attentions.1.attn"
            w, b = p[a1 + ".Wqkv.weight"], p[a1 + ".Wqkv.bias"]
            q = query + query_pos
            qkv = [self._o(F.linear(self._q(x),
                                    self._q(w[i * c:(i + 1) * c]),
                                    b[i * c:(i + 1) * c]))
                   for i, x in enumerate((q, mem_pe, memory))]
            out = self.linear(self.attention(*qkv, heads), a1 + ".out_proj")
            query = ln(query + out, f"{lp}.norms.1")
            f = f"{lp}.ffns.0.layers"
            hid = torch.relu(self.linear(query, f + ".0.0"))
            query = ln(query + self.linear(hid, f + ".1"), f"{lp}.norms.2")
        return torch.nan_to_num(ln(query, f"{pre}.post_norm"))

    def task_head(self, x, ref_inv, t: int):
        """The last decoder layer's outputs of task `t`: (logits (Q, Ct),
        codes (Q, 10))."""
        hd = self.cfg["head"]
        n_layers, hc = hd["num_decoder_layers"], hd["head_conv"]
        last = n_layers - 1
        out = {}
        for name, dim in (("center", 2), ("height", 1), ("dim", 3),
                          ("rot", 2), ("vel", 2),
                          ("cls_logits", len(hd["tasks"][t]))):
            pre = f"pts_bbox_head.task_heads.{t}.{name}"
            w0 = self.p[pre + ".0.weight"][last * hc:(last + 1) * hc, :, 0]
            y = self._o(F.linear(self._q(x), self._q(w0)))
            g = slice(last * hc, (last + 1) * hc)
            y = F.layer_norm(y, (hc,), self.p[pre + ".1.weight"][g],
                             self.p[pre + ".1.bias"][g], hd["ln_eps"])
            y = torch.relu(y)
            o = slice(last * dim, (last + 1) * dim)
            w3 = self.p[pre + ".3.weight"][o, :, 0]
            out[name] = self._o(F.linear(self._q(y), self._q(w3),
                                         self.p[pre + ".3.bias"][o]))
        r = self.cfg["lidar"]["pc_range"]
        center = torch.sigmoid(out["center"] + ref_inv[:, :2])
        height = torch.sigmoid(out["height"] + ref_inv[:, 2:3])
        cx = center[:, 0:1] * (r[3] - r[0]) + r[0]
        cy = center[:, 1:2] * (r[4] - r[1]) + r[1]
        hz = height * (r[5] - r[2]) + r[2]
        codes = torch.cat([cx, cy, hz, out["dim"], out["rot"], out["vel"]],
                          -1)
        return out["cls_logits"], codes

    # -- the frame ---------------------------------------------------------
    @torch.no_grad()
    def frame(self, batch: Dict[str, np.ndarray]) -> RefOutput:
        """One frame's host arrays (batch 1) -> its answer, every product
        in float32 (no TF32)."""
        with full_float32():
            return self._frame(batch)

    def _frame(self, batch: Dict[str, np.ndarray]) -> RefOutput:
        cfg, hd = self.cfg, self.cfg["head"]
        dev = next(iter(self.p.values())).device
        c = hd["hidden_dim"]
        ref = self.p["pts_bbox_head.reference_points.weight"]
        ref = ref.clamp(0.0, 1.0)
        ref_inv = torch.log(ref.clamp(min=1e-5)) - \
            torch.log((1.0 - ref).clamp(min=1e-5))
        ref01 = torch.sigmoid(ref_inv)
        query_pos = self.mlp(self.pos2embed(ref01, c),
                             "pts_bbox_head.bev_embedding")
        decs = []
        for agent in ("vehicle", "infrastructure"):
            prefix = f"{agent}_model"
            get = {k: torch.as_tensor(v[0]).to(dev) for k, v in batch.items()
                   if k.startswith(agent + "_")}
            mem, pos = [], []
            bev = self.bev_tokens(get[f"{agent}_points"].float(),
                                  get[f"{agent}_points_mask"], prefix)
            x = self.conv2d(bev.permute(0, 3, 1, 2),
                            self.p["pts_bbox_head.shared_conv.conv.weight"],
                            None, 1, 1)
            x = torch.relu(self.bn(x, "pts_bbox_head.shared_conv.bn",
                                   hd["bn_eps"]))
            mem.append(x[0].permute(1, 2, 0).reshape(-1, c))
            gy, gx = (cfg["lidar"]["grid_size"][1] // hd["downsample_scale"],
                      cfg["lidar"]["grid_size"][0] // hd["downsample_scale"])
            ys = (torch.arange(gy, device=dev) + 0.5) / gy
            xs = (torch.arange(gx, device=dev) + 0.5) / gx
            grid = torch.stack([xs[None, :].expand(gy, gx),
                                ys[:, None].expand(gy, gx)], -1)
            pos.append(self.mlp(self.pos2embed(grid.reshape(-1, 2), c),
                                "pts_bbox_head.bev_embedding"))
            qpos = query_pos
            if cfg.get("camera"):
                imgs = get[f"{agent}_imgs"].float()
                feats = self.image_tokens(imgs, prefix)
                v, hf, wf, _ = feats.shape
                pad_hw = tuple(imgs.shape[1:3])
                mem.append(feats.reshape(-1, c))
                i2l = get[f"{agent}_img2lidar"].float()
                pos.append(self.rv_pe((hf, wf), pad_hw, i2l).reshape(-1, c))
                qpos = qpos + self.rv_query_embed(
                    ref01, get[f"{agent}_lidar2img"].float(), i2l, pad_hw)
            decs.append(self.decoder(torch.cat(mem), torch.cat(pos), qpos))
        dec = torch.stack(decs).amax(0)
        logits, codes = zip(*[self.task_head(dec, ref_inv, t)
                              for t in range(len(hd["tasks"]))])
        return decode(list(logits), list(codes), hd)


def denormalize(codes: torch.Tensor) -> torch.Tensor:
    """(.., 10) codes -> (.., 9) boxes (x, y, z centre, w, l, h, yaw, vx,
    vy)."""
    return torch.cat([codes[..., 0:3], torch.exp(codes[..., 3:6]),
                      torch.atan2(codes[..., 6:7], codes[..., 7:8]),
                      codes[..., 8:10]], -1)


def decode(task_logits: List[torch.Tensor], task_codes: List[torch.Tensor],
           head: dict) -> RefOutput:
    """Every query's box, every (query, class) score, and the flat
    top-`max_num` scores over (query x class), highest first."""
    if len(task_logits) != 1:
        raise NotImplementedError("the reference decodes one task")
    logits = torch.cat(task_logits, -1).float()
    scores = torch.sigmoid(logits)
    # a task's queries box their own classes; one task here in practice
    boxes = denormalize(task_codes[0].float())
    k = min(head["max_num"], scores.numel())
    top = torch.topk(scores.reshape(-1), k).values
    return RefOutput(boxes.cpu().numpy().astype(np.float64),
                     scores.cpu().numpy().astype(np.float64),
                     top.cpu().numpy().astype(np.float64))
