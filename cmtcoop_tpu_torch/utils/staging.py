"""Host-to-device copies staged through reused pinned memory.

A copy from pageable memory is staged by CUDA itself on the calling thread,
through its own small pinned buffer, one piece after another (~6 GB/s on an
H100's host), with nothing else overlapping it. `upload` instead cuts the
array's bytes into chunks that go through a ring of pinned host slots,
allocated once per device and reused for the life of the process. For each
chunk it waits until the DMA that last read the slot has finished (the
slot's event), fills the slot from the array with a host `copy_` (which
PyTorch spreads over its intra-op threads), enqueues a non-blocking copy of
the slot into the chunk's part of the device tensor on the current stream,
and records the slot's event there. The fill of chunk k + 1 overlaps the
DMA of chunk k.

When `upload` returns, every copy is enqueued on the current stream, the
tensor it returns is ready in that stream's order, and the host array may
be overwritten: its bytes are in the slots or on the card. Nothing is kept
of the array itself.
"""
from __future__ import annotations

import functools
import threading

import torch

# 4 slots of 16 MiB: each chunk's fill is one parallel region, whose
# start costs ~0.1 ms, so fewer, larger chunks fill faster (a nuScenes
# frame's 80 MB in 5.7 ms at 4 x 16 MiB, 7.0 at 8 x 8, 7.7 at 16 x 4 on an
# H100's 8-core host); the pinned DMA (~46 GB/s) outruns the fill (~19),
# so a slot's DMA is done long before the slot comes round again
SLOTS = 4
SLOT_BYTES = 16 << 20


class PinnedRing:
    """`slots` pinned host buffers of `slot_bytes` each, with the event of
    the DMA that last read each, used in turn. One upload at a time."""

    def __init__(self, slots: int = SLOTS, slot_bytes: int = SLOT_BYTES):
        self.slot_bytes = slot_bytes
        self.bufs = [torch.empty(slot_bytes, dtype=torch.uint8,
                                 pin_memory=True) for _ in range(slots)]
        self.events = [None] * slots
        self.next = 0
        self.lock = threading.Lock()

    def copy(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """Enqueue the copy of the contiguous host tensor `src` into the
        contiguous CUDA tensor `dst` (same dtype and size) on the current
        stream of `dst`'s device."""
        s = src.reshape(-1).view(torch.uint8)
        d = dst.reshape(-1).view(torch.uint8)
        stream = torch.cuda.current_stream(dst.device)
        with self.lock:
            for a in range(0, s.numel(), self.slot_bytes):
                b = min(a + self.slot_bytes, s.numel())
                i, self.next = self.next, (self.next + 1) % len(self.bufs)
                ev = self.events[i]
                if ev is None:
                    ev = self.events[i] = torch.cuda.Event()
                elif not ev.query():
                    ev.synchronize()
                buf = self.bufs[i][:b - a]
                buf.copy_(s[a:b])
                d[a:b].copy_(buf, non_blocking=True)
                ev.record(stream)


@functools.lru_cache(maxsize=None)
def ring(device: torch.device) -> PinnedRing:
    """The ring that stages the uploads to `device`, made on first use."""
    with torch.cuda.device(device):
        return PinnedRing()


def upload(src: torch.Tensor, device) -> torch.Tensor:
    """The host tensor `src` as a new tensor on the CUDA `device`,
    allocated on its current stream and filled through `ring(device)`."""
    dst = torch.empty(src.shape, dtype=src.dtype, device=device)
    if dst.numel():
        ring(dst.device).copy(dst, src.contiguous())
    return dst
