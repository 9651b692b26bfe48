"""Attention (counterpart of cmtcoop_tpu/ops/attention.py), on the JAX
package's (B, H, N, Dh) layout at the public functions unless said.

- `flash_attention_packed`: eval attention on head-packed (B, N, H*Dh)
  projections, kernel 3 (csrc/flash_attention.cu; in bf16 at Dh 32 the
  tensor-core forward it shares with kernel 7, csrc/flash_train.cu).
- `flash_attention_kvmask`: the training forward with a per-key bias,
  in-kernel inverted dropout and optional (m, l) statistics, kernel 7;
  `flash_attention_bwd`: its FlashAttention-2 backward, kernel 8 (a dQ
  launch and a dK / dV / d(k_bias) launch on one argument block), both in
  csrc/flash_train.cu; `flash_attention_diff` ties them into a
  `torch.autograd.Function`, and `attend` picks the flash kernels or the
  plain attention.

Each wrapper takes its plain version for a CPU tensor and launches its
hand-written CUDA kernel for a CUDA tensor. In bfloat16 at Dh 32 (the
presets' 256 / 8 heads) kernels 3, 7 and 8 run on the tensor cores
(wgmma fed by TMA), their key range split across blocks by `split_plan`;
float32 and the tiny presets' head widths take the CUDA-core kernels. The
kernels mask the ragged query and key edges themselves, so callers pad
nothing, and kernels 7 and 8 read (B, H, N, Dh) views through their
strides, so the decoder never copies its (B, N, H*Dh) projections into
(B, H, N, Dh).

Dropout cannot reproduce the TPU's bits. In kernels 7 and 8 the keep bit
of element (bh, i, j) is a counter-based hash of (seed, bh, i, j)
(`dropout_keep`, computed exactly in int64 here and in uint32 in the
kernels), so the forward, both backward launches, a checkpoint's recompute
and the plain versions regenerate the same mask whatever their tiling. The
other dropouts (`dropout_mask`) draw from a generator seeded by an integer,
which a checkpoint's recompute also reproduces.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from cmtcoop_tpu_torch import _build
from cmtcoop_tpu_torch.ops.conv_cf import sm_count

NEG_INF = -1e9
KERNEL_HEAD_DIMS = (4, 8, 16, 32)
TRAIN_HEAD_DIMS = (8, 32)  # kernels 7 and 8: the presets' head widths
TC_HEAD_DIM = 32  # bf16 at this Dh: kernels 3, 7 and 8 on the tensor cores
# (queries a block, keys a walked tile) of kernel 8's dQ pass
# `bwd_tc::dq_kernel` (csrc/flash_train.cu: two warpgroups of 64 queries)
# and of the forward `fwd_tc::fwd_kernel` (kernels 7 and 3: three)
DQ_TC_TILE = (128, 64)
FWD_TC_TILE = (192, 128)


class SplitPlan(NamedTuple):
    """Split s walks the key tiles [s * tiles_per_split, min(key_tiles,
    (s + 1) * tiles_per_split))."""
    splits: int
    tiles_per_split: int


@functools.lru_cache(maxsize=None)
def split_plan(row_blocks: int, key_tiles: int, n_sms: int) -> SplitPlan:
    """How a flash kernel's key walk is split across blocks, for
    `row_blocks` (batch x heads x query tiles) blocks of one SM each: the
    least wave-quantized walk, ceil(blocks / SMs) waves of (tiles a split
    + 2) steps (a block's load of its rows and its partial's store count as
    about a tile each), over the splits whose ranges are all non-empty and
    that fill at least a wave where the keys allow; ties go to fewer splits
    (less partial traffic)."""
    fill = min(n_sms, row_blocks * key_tiles)
    best = None
    for s in range(1, key_tiles + 1):
        tps = -(-key_tiles // s)
        if -(-key_tiles // tps) != s or row_blocks * s < fill:
            continue
        cost = -(-row_blocks * s // n_sms) * (tps + 2)
        if best is None or cost < best[0]:
            best = (cost, SplitPlan(s, tps))
    return best[1]


def _tma_ready(*tensors) -> bool:
    """TMA addresses a bf16 (B, H, N, 32) view (or (B, N, H*32) tensor) with
    16-byte aligned base and strides."""
    return all(t.data_ptr() % 16 == 0
               and all(st * 2 % 16 == 0 for st in t.stride()[:-1])
               for t in tensors)

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser on int64 values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dropout_threshold(rate: float) -> int:
    """A 32-bit hash at or above this is kept (`_dropout_keep`'s
    threshold)."""
    return min(int(rate * 4294967296.0), 4294967295)


def dropout_keep(seed: int, rate: float, bh: int, nq: int, nk: int,
                 device=None, bh0: int = 0) -> torch.Tensor:
    """(bh, nq, nk) bool keep mask of elements (bh0 + b, i, j): the hash
    fmix32(fmix32(fmix32(seed + bh * 0x9E3779B9) ^ i * 0x85EBCA77) ^
    j * 0xC2B2AE3D) >= `dropout_threshold(rate)`, the function kernels 7
    and 8 compute."""
    def ar(lo, n):
        return torch.arange(lo, lo + n, dtype=torch.int64, device=device)
    base = _fmix32((int(seed) + _mul32(ar(bh0, bh), 0x9E3779B9)) & _M32)
    row = _fmix32(base[:, None] ^ _mul32(ar(0, nq), 0x85EBCA77)[None])
    h = _fmix32(row[:, :, None] ^ _mul32(ar(0, nk), 0xC2B2AE3D)[None, None])
    return h >= dropout_threshold(rate)


def dropout_mask(shape, rate: float, seed: int, device) -> torch.Tensor:
    """Bool keep mask of `shape`, kept with probability 1 - rate, drawn on
    `device` from a generator seeded with `seed` alone, so a checkpoint's
    recompute draws the same mask (a `torch.Generator` passed in would not
    be restored by `torch.utils.checkpoint`)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.rand(shape, generator=gen, device=device) >= rate


def dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Inverted dropout (flax `nn.Dropout`: kept values / (1 - rate)) with
    the mask of `dropout_mask`."""
    if rate <= 0.0:
        return x
    keep = dropout_mask(x.shape, rate, seed, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def mha_reference(q, k, v, bias: Optional[torch.Tensor] = None,
                  dropout_rate: float = 0.0,
                  keep: Optional[torch.Tensor] = None):
    """Plain softmax attention on (B, H, N, Dh), float32 logits; `bias`
    additive, broadcastable to (B, H, Nq, Nk). With `dropout_rate` > 0,
    inverted dropout after the softmax with no renormalisation (torch's
    attn_drop), `keep` a bool mask broadcastable to (B, H, Nq, Nk)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits / math.sqrt(q.shape[-1])
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0:
        probs = torch.where(keep, probs / (1.0 - dropout_rate),
                            torch.zeros_like(probs))
    return torch.matmul(probs, v.float()).to(v.dtype)


def flash_attention_packed_reference(q, k, v, k_bias, num_heads: int):
    """Plain version: softmax(q.k^T / sqrt(Dh) + bias) @ v per head."""
    b, nq, c = q.shape
    dh = c // num_heads

    def split(x):
        return x.reshape(b, -1, num_heads, dh).transpose(1, 2)

    out = mha_reference(split(q), split(k), split(v),
                        k_bias[:, None, None, :])
    return out.transpose(1, 2).reshape(b, nq, c)


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           k_bias: Optional[torch.Tensor],
                           num_heads: int) -> torch.Tensor:
    """q (B, Nq, H*Dh), k/v (B, Nk, H*Dh), k_bias (B, Nk) additive (0 or
    NEG_INF; None = no mask) -> (B, Nq, H*Dh). In bf16 at Dh 32 q, k and v
    must be 16-byte aligned for TMA (else ValueError)."""
    b, nq, c = q.shape
    nk = k.shape[1]
    if k_bias is None:
        k_bias = torch.zeros(b, nk, dtype=torch.float32, device=q.device)
    if q.device.type == "cpu":
        return flash_attention_packed_reference(q, k, v, k_bias, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_packed: no kernel for {q.device}")
    dh = c // num_heads
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not (t.is_contiguous() and t.dtype == q.dtype
                and t.device == q.device and t.dim() == 3):
            raise ValueError(f"flash_attention_packed: {name} must be a "
                             "contiguous 3-D tensor like q")
    if (c % num_heads or dh not in KERNEL_HEAD_DIMS or k.shape != (b, nk, c)
            or v.shape != (b, nk, c)):
        raise ValueError(f"flash_attention_packed: unsupported shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} heads "
                         f"{num_heads} (Dh must be one of {KERNEL_HEAD_DIMS})")
    k_bias = k_bias.to(torch.float32).contiguous()
    if k_bias.shape != (b, nk):
        raise ValueError("flash_attention_packed: k_bias must be (B, Nk)")
    out = torch.empty_like(q)
    if q.dtype == torch.bfloat16 and dh == TC_HEAD_DIM:
        _packed_fwd_tc(q, k, v, k_bias, out, num_heads)
        return out
    _build.check(_build.lib().cmt_flash_attention_packed(
        _build.dtype_code(q.dtype), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_bias.data_ptr(), out.data_ptr(), b, nq, nk, num_heads, dh,
        1.0 / math.sqrt(dh), _build.stream_ptr(q.device)),
        "cmt_flash_attention_packed")
    _build.count("flash_attention_packed", (nq, nk, num_heads, dh))
    return out


def _packed_fwd_tc(q, k, v, k_bias, out, num_heads):
    """Kernel 3 in bf16 at Dh 32: kernel 7's tensor-core forward, dropout
    off and no (m, l), reading the checked packed (B, N, H*Dh) tensors as
    (B, H, N, Dh) through their strides and writing `out` in the same
    layout. Its argument block is built here, not by `_train_args`, for the
    host's sake: the eval frame is host-bound."""
    if not _tma_ready(q, k, v):
        raise ValueError("flash_attention_packed: q, k, v must be 16-byte "
                         "aligned for TMA")
    b, nq, c = q.shape
    nk = k.shape[1]
    a = _FlashArgs()
    a.q, a.k, a.v, a.kbias, a.out = (t.data_ptr()
                                     for t in (q, k, v, k_bias, out))
    a.sq = (ctypes.c_longlong * 3)(nq * c, TC_HEAD_DIM, c)
    a.sk = a.sv = (ctypes.c_longlong * 3)(nk * c, TC_HEAD_DIM, c)
    a.B, a.H, a.nq, a.nk, a.dh = b, num_heads, nq, nk, TC_HEAD_DIM
    a.dtype = _build.dtype_code(torch.bfloat16)
    a.scale, a.keep_scale = 1.0 / math.sqrt(TC_HEAD_DIM), 1.0
    keep = _fwd_tc_plan(a, q.device)  # alive to the launch
    _launch("flash_train_fwd", a, q.device, "flash_attention_packed")


def wgmma_check(which: int, a: torch.Tensor, b: torch.Tensor,
                c: Optional[torch.Tensor] = None):
    """One product of the Hopper primitives the bf16 flash kernels build on
    (csrc/wgmma_selftest.cu), on bf16 row-major CUDA tensors of 32 columns:
    which 0: a (64, 32) @ b (32, 32)^T; 1: a @ b (32, 32); 2: x = a @ b
    (64, 32)^T, then bf16(x) @ c (64, 32). Returns the float32 product and,
    for 2, x."""
    d = torch.empty(64, 32, dtype=torch.float32, device=a.device)
    x = torch.empty(64, 64, dtype=torch.float32, device=a.device)
    ins = [t.contiguous() for t in (a, b, c) if t is not None]
    if any(t.dtype != torch.bfloat16 or t.device.type != "cuda"
           or t.shape[1] != 32 for t in ins):
        raise ValueError("wgmma_check: bf16 CUDA tensors of 32 columns")
    a, b = ins[:2]
    c = ins[2] if len(ins) > 2 else None
    _build.check(_build.lib().cmt_wgmma_selftest(
        which, a.data_ptr(), b.data_ptr(), _build.ptr(c), d.data_ptr(),
        x.data_ptr(), _build.stream_ptr(a.device)), "cmt_wgmma_selftest")
    return (d, x) if which == 2 else d


# ----------------------- training attention (kernels 7 and 8) ---------------

class _FlashArgs(ctypes.Structure):
    """Mirror of `FlashArgs` in csrc/flash_train.cu (every field 8 bytes)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "q", "k", "v", "dout", "kbias", "m", "l", "delta", "out", "dq", "dk",
        "dv", "m_out", "l_out", "dkb")]
        + [(n, ctypes.c_longlong * 3) for n in ("sq", "sk", "sv", "sdo")]
        + [(n, ctypes.c_longlong) for n in (
            "B", "H", "nq", "nk", "dh", "dtype", "seed", "thresh")]
        + [("scale", ctypes.c_double), ("keep_scale", ctypes.c_double),
           ("dq_part", ctypes.c_void_p), ("dq_splits", ctypes.c_longlong),
           ("dq_tiles_per_split", ctypes.c_longlong),
           ("o_part", ctypes.c_void_p), ("ml_part", ctypes.c_void_p)]
        + [(n, ctypes.c_longlong) for n in ("splits", "tiles_per_split")])


def _keep_factor(seed, rate, b, h, nq, nk, device):
    """(B, H, Nq, Nk) float32 keep factor of the kernels' dropout: 1/(1-rate)
    where `dropout_keep` keeps, else 0."""
    keep = dropout_keep(seed, rate, b * h, nq, nk, device)
    return keep.reshape(b, h, nq, nk).float() * (1.0 / (1.0 - rate))


def _logits(q, k, k_bias):
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return s + k_bias.float()[:, None, None, :]


def flash_attention_kvmask_reference(q, k, v, k_bias, with_stats=False,
                                     dropout_rate=0.0, seed=0):
    """Plain version of kernel 7, on (B, H, N, Dh): s = q.k / sqrt(Dh) +
    k_bias[key] in float32, m = max(NEG_INF, max_j s), l = sum_j exp(s - m),
    out = (dropout(exp(s - m)) @ v) / max(l, 1e-30): the keep mask scales
    the numerator only, so l stays the full softmax sum."""
    b, h, nq, _ = q.shape
    s = _logits(q, k, k_bias)
    m = s.amax(-1).clamp(min=NEG_INF)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    if dropout_rate > 0.0:
        p = p * _keep_factor(seed, dropout_rate, b, h, nq, k.shape[2],
                             q.device)
    out = (torch.matmul(p, v.float()) / l.clamp(min=1e-30)[..., None]).to(
        q.dtype)
    return (out, m, l) if with_stats else out


def flash_attention_bwd_reference(q, k, v, k_bias, out, m, l, dout,
                                  dropout_rate=0.0, seed=0):
    """Plain version of kernel 8 (`_flash_backward`'s arithmetic): P
    recomputed from (m, l), the keep mask replayed on P and on dP,
    dS = P * (dP - delta) with delta = rowsum(dO * O); returns dq, dk, dv
    and d(k_bias) (B, Nk) summed over queries and heads."""
    b, h, nq, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    do = dout.float()
    delta = (do * out.float()).sum(-1, keepdim=True)
    p = torch.exp(_logits(q, k, k_bias) - m[..., None]) / l.clamp(
        min=1e-30)[..., None]
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    pv = p
    if dropout_rate > 0.0:
        kf = _keep_factor(seed, dropout_rate, b, h, nq, k.shape[2], q.device)
        pv, dp = p * kf, dp * kf
    ds = p * (dp - delta)
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(pv.transpose(-1, -2), do)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            ds.sum(dim=(1, 2)).to(k_bias.dtype))


def _strides(name, t, shape, dtype, dev):
    """(batch, head, row) strides of a (B, H, N, Dh) view with unit stride
    along Dh, or raise."""
    if (tuple(t.shape) != shape or t.dtype != dtype or t.device != dev
            or t.stride(-1) != 1):
        raise ValueError(f"flash attention: {name} must be a {shape} view in "
                         f"{dtype} on {dev} with unit stride along Dh, got "
                         f"{tuple(t.shape)} {t.dtype} {t.device} strides "
                         f"{t.stride()}")
    return (ctypes.c_longlong * 3)(*t.stride()[:3])


def _train_args(q, k, v, k_bias, dropout_rate, seed):
    """The kernels' argument block for q (B, H, Nq, Dh), k / v (B, H, Nk, Dh)
    views and k_bias (B, Nk), with the checks the kernels rely on."""
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    dev = q.device
    if dh not in TRAIN_HEAD_DIMS or q.dtype not in (torch.float32,
                                                     torch.bfloat16):
        raise ValueError(f"flash attention: Dh {dh} (one of "
                         f"{TRAIN_HEAD_DIMS}) in float32 or bfloat16, got "
                         f"{q.dtype}")
    if k_bias.shape != (b, nk) or k_bias.dtype != torch.float32 or \
            not k_bias.is_contiguous():
        raise ValueError("flash attention: k_bias must be contiguous float32 "
                         "(B, Nk)")
    if not 0 <= int(seed) < 2 ** 32 or not 0.0 <= dropout_rate < 1.0:
        raise ValueError("flash attention: seed in [0, 2^32), rate in [0, 1)")
    a = _FlashArgs()
    a.q, a.k, a.v, a.kbias = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              k_bias.data_ptr())
    a.sq = _strides("q", q, (b, h, nq, dh), q.dtype, dev)
    a.sk = _strides("k", k, (b, h, nk, dh), q.dtype, dev)
    a.sv = _strides("v", v, (b, h, nk, dh), q.dtype, dev)
    a.B, a.H, a.nq, a.nk, a.dh = b, h, nq, nk, dh
    a.dtype = _build.dtype_code(q.dtype)
    a.seed = int(seed)
    a.thresh = dropout_threshold(dropout_rate) if dropout_rate > 0.0 else 0
    a.scale = 1.0 / math.sqrt(dh)
    a.keep_scale = 1.0 / (1.0 - dropout_rate)
    return a


def _launch(name: str, a: _FlashArgs, dev, count_as: str = "") -> None:
    """Launches `cmt_<name>` on the block, counted as `count_as` (default
    `name`) at (Nq, Nk, H, Dh)."""
    fn = getattr(_build.lib(), "cmt_" + name)
    _build.check(fn(ctypes.addressof(a), _build.stream_ptr(dev)),
                 "cmt_" + name)
    _build.count(count_as or name, (a.nq, a.nk, a.H, a.dh))


def _tensor_cores(a: _FlashArgs) -> bool:
    """Kernels 7 and 8 run on the tensor cores (csrc/flash_train.cu `fwd_tc`,
    `bwd_tc`)."""
    return a.dtype == _build.dtype_code(torch.bfloat16) and \
        a.dh == TC_HEAD_DIM


def flash_attention_kvmask(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           k_bias: Optional[torch.Tensor] = None,
                           with_stats: bool = False,
                           dropout_rate: float = 0.0, seed: int = 0):
    """Training flash forward, kernel 7 (counterpart of the JAX
    `flash_attention_kvmask`): q (B, H, Nq, Dh), k / v (B, H, Nk, Dh), any
    views with unit stride along Dh (in bf16 at Dh 32 also 16-byte aligned
    for TMA, else ValueError); k_bias (B, Nk) additive (None = no mask).
    Inverted dropout of the normalised P with the keep mask of
    `dropout_keep(seed, ...)` when `dropout_rate` > 0. Returns out
    (B, H, Nq, Dh) (a view of a (B, Nq, H, Dh) tensor on the card), and with
    `with_stats` also m and l (B, H, Nq) float32."""
    b, h, nq, dh = q.shape
    nk = k.shape[2]
    if k_bias is None:
        k_bias = torch.zeros(b, nk, dtype=torch.float32, device=q.device)
    if q.device.type == "cpu":
        return flash_attention_kvmask_reference(q, k, v, k_bias, with_stats,
                                                dropout_rate, seed)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_kvmask: no kernel for {q.device}")
    a = _train_args(q, k, v, k_bias, dropout_rate, seed)
    out = torch.empty(b, nq, h, dh, dtype=q.dtype, device=q.device)
    a.out = out.data_ptr()
    m = l = None
    if with_stats:
        m = torch.empty(b, h, nq, dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        a.m_out, a.l_out = m.data_ptr(), l.data_ptr()
    if _tensor_cores(a):
        if not _tma_ready(q, k, v):
            raise ValueError("flash attention: q, k and v must be 16-byte "
                             "aligned for TMA")
        keep = _fwd_tc_plan(a, q.device)  # alive to the launch
    _launch("flash_train_fwd", a, q.device)
    out = out.transpose(1, 2)
    return (out, m, l) if with_stats else out


def _fwd_tc_plan(a: _FlashArgs, dev):
    """Kernel 7's tensor-core launch on its argument block: the key walk
    split by `split_plan` over `FWD_TC_TILE`s; with more than one split,
    the float32 partials O and (m log2 e, l), which the caller keeps alive
    until the launch is enqueued."""
    bq, bk = FWD_TC_TILE
    bh, nq = a.B * a.H, a.nq
    plan = split_plan(bh * -(-nq // bq), -(-a.nk // bk), sm_count(dev))
    a.splits, a.tiles_per_split = plan
    if plan.splits == 1:
        return None
    o_part = torch.empty(plan.splits, bh, nq, TC_HEAD_DIM,
                         dtype=torch.float32, device=dev)
    ml_part = torch.empty(plan.splits, bh, nq, 2, dtype=torch.float32,
                          device=dev)
    a.o_part, a.ml_part = o_part.data_ptr(), ml_part.data_ptr()
    return o_part, ml_part


def _bwd_args(q, k, v, k_bias, out, m, l, dout, dropout_rate, seed):
    """Kernel 8's argument block, with delta = rowsum(dO * O) computed here
    (as JAX does outside its kernels); returns it and the tensors it points
    to, which the caller keeps alive until the launches are enqueued."""
    b, h, nq, dh = q.shape
    a = _train_args(q, k, v, k_bias, dropout_rate, seed)
    if dout.stride(-1) != 1 or (_tensor_cores(a) and not _tma_ready(dout)):
        dout = dout.contiguous()
    a.sdo = _strides("dout", dout, (b, h, nq, dh), q.dtype, q.device)
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    m, l = m.contiguous(), l.contiguous()
    for name, t in (("m", m), ("l", l)):
        if t.shape != (b, h, nq) or t.dtype != torch.float32:
            raise ValueError(f"flash_attention_bwd: {name} must be float32 "
                             "(B, H, Nq)")
    a.dout, a.m, a.l, a.delta = (dout.data_ptr(), m.data_ptr(),
                                 l.data_ptr(), delta.data_ptr())
    if _tensor_cores(a) and not _tma_ready(q, k, v):
        raise ValueError("flash_attention_bwd: q, k and v must be 16-byte "
                         "aligned for TMA")
    return a, (dout, delta, m, l)


def _bwd_dq(a: _FlashArgs, q) -> torch.Tensor:
    """Kernel 8's dQ launch on a prepared block (one block per (bh, query
    tile), walking the keys; in bf16 at Dh 32 the keys split across blocks
    by `split_plan`, the float32 partials summed in split order): dq as a
    (B, H, Nq, Dh) view."""
    b, h, nq, dh = q.shape
    dq = torch.empty(b, nq, h, dh, dtype=q.dtype, device=q.device)
    a.dq = dq.data_ptr()
    part = None
    if _tensor_cores(a):
        bq, bk = DQ_TC_TILE
        plan = split_plan(b * h * -(-nq // bq), -(-a.nk // bk),
                          sm_count(q.device))
        a.dq_splits, a.dq_tiles_per_split = plan
        if plan.splits > 1:
            part = torch.empty(plan.splits, b, nq, h, dh,
                               dtype=torch.float32, device=q.device)
        a.dq_part = _build.ptr(part)
    _launch("flash_train_bwd_dq", a, q.device)
    return dq.transpose(1, 2)


def _bwd_dkv(a: _FlashArgs, k, k_bias, with_dk_bias: bool = True):
    """Kernel 8's dK / dV / d(k_bias) launch on a prepared block (one block
    per (bh, key tile), walking the queries): dk, dv as (B, H, Nk, Dh)
    views and d(k_bias) (B, Nk), its per-head sums added here, or None
    (not written) without `with_dk_bias`."""
    b, h, nk, dh = k.shape
    dk = torch.empty(b, nk, h, dh, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    dkb = (torch.empty(b, h, nk, dtype=torch.float32, device=k.device)
           if with_dk_bias else None)
    a.dk, a.dv = dk.data_ptr(), dv.data_ptr()
    a.dkb = dkb.data_ptr() if with_dk_bias else None
    _launch("flash_train_bwd_dkv", a, k.device)
    return (dk.transpose(1, 2), dv.transpose(1, 2),
            dkb.sum(1).to(k_bias.dtype) if with_dk_bias else None)


def flash_attention_bwd(q, k, v, k_bias, out, m, l, dout,
                        dropout_rate: float = 0.0, seed: int = 0,
                        with_dk_bias: bool = True):
    """FlashAttention-2 backward, kernel 8 (counterpart of the JAX
    `_flash_backward`): the dQ launch, then the dK / dV / d(k_bias) launch,
    both recomputing P from the forward's (m, l) and replaying its dropout
    mask. Returns dq, dk, dv ((B, H, N, Dh) views) and d(k_bias) (B, Nk),
    summed over queries and heads (None without `with_dk_bias`)."""
    if q.device.type == "cpu":
        grads = flash_attention_bwd_reference(q, k, v, k_bias, out, m, l,
                                              dout, dropout_rate, seed)
        return grads if with_dk_bias else grads[:3] + (None,)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for {q.device}")
    a, keep = _bwd_args(q, k, v, k_bias, out, m, l, dout, dropout_rate, seed)
    return (_bwd_dq(a, q),) + _bwd_dkv(a, k, k_bias, with_dk_bias)


class _FlashDiff(torch.autograd.Function):
    """Kernel 7 forward (with stats) and kernel 8 backward (the JAX
    `flash_attention_diff` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, k_bias, dropout_rate, seed):
        out, m, l = flash_attention_kvmask(q, k, v, k_bias, True,
                                           dropout_rate, seed)
        ctx.save_for_backward(q, k, v, k_bias, out, m, l)
        ctx.rate, ctx.seed = dropout_rate, seed
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, k_bias, out, m, l = ctx.saved_tensors
        dq, dk, dv, dkb = flash_attention_bwd(q, k, v, k_bias, out, m, l,
                                              dout, ctx.rate, ctx.seed,
                                              ctx.needs_input_grad[3])
        return dq, dk, dv, dkb, None, None


def flash_attention_diff(q, k, v, k_bias=None, seed: int = 0,
                         dropout_rate: float = 0.0) -> torch.Tensor:
    """Differentiable training attention on (B, H, N, Dh): kernel 7 forward,
    kernel 8 backward (plain versions on the CPU). `seed` selects the
    dropout mask; nothing of size Nq x Nk is kept for the backward."""
    if k_bias is None:
        k_bias = torch.zeros(q.shape[0], k.shape[2], dtype=torch.float32,
                             device=q.device)
    return _FlashDiff.apply(q, k, v, k_bias, float(dropout_rate), int(seed))


def attend(q, k, v, bias=None, k_bias=None, impl: str = "reference",
           dropout_rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """The JAX `attend` with its two paths named by the caller: the flash
    kernels for long-KV attention with at most a per-key bias
    (`impl="flash"`), the plain `mha_reference` otherwise (the DN-masked
    self-attention), its dropout mask from `dropout_mask(seed)`. Nothing is
    padded: the kernels mask the ragged edges."""
    if impl not in ("flash", "reference"):
        raise ValueError(f"attend: impl must be 'flash' or 'reference', got "
                         f"{impl!r}")
    if impl == "flash":
        if bias is not None:
            raise ValueError(
                "attend(impl='flash') cannot apply a 2D attention bias; use "
                "k_bias for KV padding or impl='reference' for DN masks")
        return flash_attention_diff(q, k, v, k_bias, seed, dropout_rate)
    if k_bias is not None:
        kb = k_bias[:, None, None, :]
        bias = kb if bias is None else bias + kb
    keep = None
    if dropout_rate > 0.0:
        keep = dropout_mask((q.shape[0], q.shape[1], q.shape[2], k.shape[2]),
                            dropout_rate, seed, q.device)
    return mha_reference(q, k, v, bias, dropout_rate, keep)
