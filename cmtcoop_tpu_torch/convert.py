"""JAX package variables -> this package's state_dict.

`from_jax_variables` takes the flax `{"params", "batch_stats"}` tree of a
`cmtcoop_tpu` detector (`CmtDetector` or `CmtCoopDetector`; LiDAR, camera
or fusion; eval modules) as numpy arrays and returns the reference-layout
state_dict that this package's detector loads with
`load_state_dict(strict=True)`. It is the inverse of
`cmtcoop_tpu/train/torch_convert.py::convert_state_dict` on every module of
the eval path (VoVNet, CPFPN, the pillar encoder, SECOND/FPN, the head):

  Conv2d            (kh, kw, I, O)            -> (O, I, kh, kw)
  ConvTranspose2d   (kh, kw, I, O), flipped   -> (I, O, kh, kw)
  Linear            (I, O)                    -> (O, I)
  BN                scale/bias + mean/var     -> weight/bias/running_*
  spconv            (K = kz*ky*kx, I, O)      -> (O, kz, ky, kx, I)
  MHA q/k/v         3 x (C, C)                -> in_proj (3C, C) / Wqkv
  grouped Conv1d    (L, Cin, Cout)            -> (L*Cout, Cin, 1)
  GroupLayerNorm    (L, C)                    -> (L*C,)
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(w):
    return np.transpose(w, (3, 2, 0, 1))


def _deconv(w):
    return np.transpose(np.asarray(w)[::-1, ::-1], (2, 3, 0, 1))


def _sparse(w):
    k, i, o = w.shape
    kk = (3, 3, 3) if k == 27 else (3, 1, 1)
    return np.transpose(np.reshape(w, kk + (i, o)), (4, 0, 1, 2, 3))


def _grouped(w):
    g, cin, cout = w.shape
    return np.transpose(w, (0, 2, 1)).reshape(g * cout, cin, 1)


class _Out:
    def __init__(self):
        self.sd: Dict[str, torch.Tensor] = {}

    def put(self, key: str, value) -> None:
        self.sd[key] = _t(value)

    def bn(self, key: str, p: Mapping, s: Mapping) -> None:
        self.put(f"{key}.weight", p["scale"])
        self.put(f"{key}.bias", p["bias"])
        self.put(f"{key}.running_mean", s["mean"])
        self.put(f"{key}.running_var", s["var"])

    def linear(self, key: str, p: Mapping) -> None:
        self.put(f"{key}.weight", np.transpose(p["kernel"]))
        if "bias" in p:
            self.put(f"{key}.bias", p["bias"])

    def conv_bn(self, conv_key: str, bn_key: str, p: Mapping,
                s: Mapping) -> None:
        """A flax `ConvBNReLU` (`Conv_0`, `BatchNorm_0`)."""
        self.put(conv_key, _conv(p["Conv_0"]["kernel"]))
        self.bn(bn_key, p["BatchNorm_0"], s["BatchNorm_0"])


def _numbered(tree: Mapping, pattern: str):
    """Sorted integer captures of the keys of `tree` matching `pattern`."""
    out = set()
    for k in tree:
        m = re.fullmatch(pattern, k)
        if m:
            out.add(tuple(int(g) for g in m.groups()))
    return sorted(out)


def _vovnet(out: _Out, key: str, p: Mapping, s: Mapping) -> None:
    """flax `VoVNet` -> the reference's `stem.stem_{i}/…`,
    `stage{s}.OSA{s}_{b+1}.{layers.{i},concat,ese}.…` keys."""
    for i in (1, 2, 3):
        unit = f"{key}.stem.stem_{i}"
        out.conv_bn(f"{unit}/conv.weight", f"{unit}/norm", p[f"stem{i}"],
                    s[f"stem{i}"])
    for st, b in _numbered(p, r"stage(\d+)_block(\d+)"):
        bp, bs = p[f"stage{st}_block{b}"], s[f"stage{st}_block{b}"]
        name = f"OSA{st}_{b + 1}"
        mod = f"{key}.stage{st}.{name}"
        for (i,) in _numbered(bp, r"conv(\d+)"):
            unit = f"{mod}.layers.{i}.{name}_{i}"
            out.conv_bn(f"{unit}/conv.weight", f"{unit}/norm", bp[f"conv{i}"],
                        bs[f"conv{i}"])
        unit = f"{mod}.concat.{name}_concat"
        out.conv_bn(f"{unit}/conv.weight", f"{unit}/norm", bp["concat"],
                    bs["concat"])
        out.put(f"{mod}.ese.fc.weight", _conv(bp["ese"]["fc"]["kernel"]))
        out.put(f"{mod}.ese.fc.bias", bp["ese"]["fc"]["bias"])


def _cpfpn(out: _Out, key: str, p: Mapping) -> None:
    for (i,) in _numbered(p, r"lateral(\d+)"):
        out.put(f"{key}.lateral_convs.{i}.conv.weight",
                _conv(p[f"lateral{i}"]["kernel"]))
        out.put(f"{key}.lateral_convs.{i}.conv.bias", p[f"lateral{i}"]["bias"])
    out.put(f"{key}.fpn_convs.0.conv.weight", _conv(p["fpn0"]["kernel"]))
    out.put(f"{key}.fpn_convs.0.conv.bias", p["fpn0"]["bias"])


def _agent(out: _Out, pre: str, p: Mapping, s: Mapping) -> None:
    if "img_backbone" in p:
        _vovnet(out, pre + "img_backbone", p["img_backbone"],
                s["img_backbone"])
        _cpfpn(out, pre + "img_neck", p["img_neck"])
    if "pts_middle_encoder" in p:
        _lidar(out, pre, p, s)


def _encoder(out: _Out, mp: str, ep: Mapping, es: Mapping) -> None:
    """The sparse encoder's tree (pillar and gather encoders share it) ->
    keys under the prefix `mp` (ending in a dot, or empty)."""
    out.put(f"{mp}conv_input.0.weight", _sparse(ep["conv_input"]["conv"]
                                               ["kernel"]))
    out.bn(f"{mp}conv_input.1", ep["conv_input"]["bn"],
           es["conv_input"]["bn"])
    blocks = _numbered(ep, r"stage(\d+)_block(\d+)")
    n_stages = max(i for i, _ in blocks) + 1
    for i in range(n_stages):
        layer = f"{mp}encoder_layers.encoder_layer{i + 1}"
        js = [j for ii, j in blocks if ii == i]
        for j in js:
            bp, bs = ep[f"stage{i}_block{j}"], es[f"stage{i}_block{j}"]
            for n in ("1", "2"):
                out.put(f"{layer}.{j}.conv{n}.weight",
                        _sparse(bp[f"conv{n}"]["kernel"]))
                out.bn(f"{layer}.{j}.norm{n}", bp[f"bn{n}"], bs[f"bn{n}"])
        if f"stage{i}_down" in ep:
            dp, ds = ep[f"stage{i}_down"], es[f"stage{i}_down"]
            out.put(f"{layer}.{len(js)}.0.weight", _sparse(dp["conv"]
                                                          ["kernel"]))
            out.bn(f"{layer}.{len(js)}.1", dp["bn"], ds["bn"])
    out.put(f"{mp}conv_out.0.weight", _sparse(ep["conv_out"]["conv"]
                                             ["kernel"]))
    out.bn(f"{mp}conv_out.1", ep["conv_out"]["bn"], es["conv_out"]["bn"])


def _lidar(out: _Out, pre: str, p: Mapping, s: Mapping) -> None:
    _encoder(out, pre + "pts_middle_encoder.", p["pts_middle_encoder"],
             s["pts_middle_encoder"])

    bp, bs = p["pts_backbone"], s["pts_backbone"]
    for i, j in _numbered(bp, r"block(\d+)_conv(\d+)"):
        key = f"{pre}pts_backbone.blocks.{i}"
        out.conv_bn(f"{key}.{3 * j}.weight", f"{key}.{3 * j + 1}",
                    bp[f"block{i}_conv{j}"], bs[f"block{i}_conv{j}"])

    np_, ns = p["pts_neck"], s["pts_neck"]
    for (i,) in _numbered(np_, r"deblock(\d+)_bn"):
        key = f"{pre}pts_neck.deblocks.{i}"
        if f"deblock{i}_up" in np_:
            out.put(f"{key}.0.weight", _deconv(np_[f"deblock{i}_up"]
                                               ["kernel"]))
        else:
            out.put(f"{key}.0.weight", _conv(np_[f"deblock{i}_conv"]
                                             ["kernel"]))
        out.bn(f"{key}.1", np_[f"deblock{i}_bn"], ns[f"deblock{i}_bn"])


def _head(out: _Out, p: Mapping, s: Mapping) -> None:
    hd = "pts_bbox_head"
    if "shared_conv" in p:
        out.conv_bn(f"{hd}.shared_conv.conv.weight", f"{hd}.shared_conv.bn",
                    p["shared_conv"], s["shared_conv"])
    out.put(f"{hd}.reference_points.weight", p["reference_points"])
    for name in ("bev_embedding", "rv_embedding"):
        if name in p:
            out.linear(f"{hd}.{name}.0", p[name]["Dense_0"])
            out.linear(f"{hd}.{name}.2", p[name]["Dense_1"])
    for (t,) in _numbered(p, r"task_heads_(\d+)"):
        th = p[f"task_heads_{t}"]
        for name in ("center", "height", "dim", "rot", "vel", "cls_logits"):
            key = f"{hd}.task_heads.{t}.{name}"
            out.put(f"{key}.0.weight", _grouped(th[f"{name}_fc0"]["kernel"]))
            ln = th[f"{name}_ln0"]
            out.put(f"{key}.1.weight", np.reshape(ln["scale"], -1))
            out.put(f"{key}.1.bias", np.reshape(ln["bias"], -1))
            o = th[f"{name}_out"]
            out.put(f"{key}.3.weight", _grouped(o["kernel"]))
            out.put(f"{key}.3.bias", np.reshape(o["bias"], -1))
    dec = p["decoder"]
    for (l,) in _numbered(dec, r"layer(\d+)"):
        lp = dec[f"layer{l}"]
        key = f"{hd}.transformer.decoder.layers.{l}"
        for a, (src, w_name, b_name) in enumerate((
                ("self_attn", "in_proj_weight", "in_proj_bias"),
                ("cross_attn", "Wqkv.weight", "Wqkv.bias"))):
            ap = lp[src]
            out.put(f"{key}.attentions.{a}.attn.{w_name}", np.concatenate(
                [np.transpose(ap[n]["kernel"])
                 for n in ("q_proj", "k_proj", "v_proj")]))
            out.put(f"{key}.attentions.{a}.attn.{b_name}", np.concatenate(
                [ap[n]["bias"] for n in ("q_proj", "k_proj", "v_proj")]))
            out.linear(f"{key}.attentions.{a}.attn.out_proj", ap["out_proj"])
        out.linear(f"{key}.ffns.0.layers.0.0", lp["ffn"]["Dense_0"])
        out.linear(f"{key}.ffns.0.layers.1", lp["ffn"]["Dense_1"])
        for n in range(3):
            ln = lp[f"norm{n + 1}"]
            out.put(f"{key}.norms.{n}.weight", ln["scale"])
            out.put(f"{key}.norms.{n}.bias", ln["bias"])
    out.put(f"{hd}.transformer.decoder.post_norm.weight",
            dec["post_norm"]["scale"])
    out.put(f"{hd}.transformer.decoder.post_norm.bias",
            dec["post_norm"]["bias"])


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax `{"params", "batch_stats"}` (numpy leaves) -> state_dict of
    float32 CPU tensors, reference key layout (coop prefixes
    `vehicle_model.` / `infrastructure_model.`; single-agent extractor keys
    at the top level). A tree without `pts_bbox_head` gives the extractor's
    keys alone, the tree of a sparse encoder alone (`PillarSparseEncoder` or
    `SparseEncoder`) the encoder's."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out = _Out()
    if "conv_input" in params:
        _encoder(out, "", params, stats)
        return out.sd
    agents = [a for a in ("vehicle_model", "infrastructure_model")
              if a in params]
    if agents:
        for a in agents:
            _agent(out, a + ".", params[a], stats[a])
    else:
        _agent(out, "", params["extractor"], stats["extractor"])
    if "pts_bbox_head" in params:
        _head(out, params["pts_bbox_head"], stats.get("pts_bbox_head", {}))
    return out.sd
