"""CUDA graphs of a detector's eval frame.

A frame runs its LiDAR branch and its head as segments: each call of a
`Frame` runs one function on tensors (a program span's body), and the code
between the calls (the camera branch, the head's `shared_conv` on kernel
4, the decoder's cross-attention on kernel 3) stays on the host. The
detector decides per forward whether its segments may be graphed, from
what it can observe: CUDA tensors, eval mode, autograd off, and a LiDAR
branch (if any) on the pillar encoder. A frame of a new key (the batch's
shapes and dtypes, and each graphed module's parameters and buffers by
data pointer and version, the rule of `layers._pack_key`: a pack rebuilt
after `load_state_dict` or a weight's in-place copy would leave a graph
reading stale operands) runs eager once; the next frame of that key
captures every segment as its own `torch.cuda.CUDAGraph`, in order, into
one private memory pool; later frames of the key replay them.

A segment's tensor inputs are internal (an earlier segment's output) or
external: an external input is copied into a static buffer before each
replay (buffers of one shape and dtype are shared by the segments of a
frame, never by two inputs of one segment nor with a buffer a segment
returned). A segment's outputs live in the pool, and each replay hands
back the captured outputs as tensors that do not hold their memory
(`_borrow`): once the capture frame ends the allocator counts the pool's
blocks free, so `torch.cuda.max_memory_allocated` no longer sees them
(`graph.pool_bytes` does), and only the graphs write them. Host code
between segments reads and computes with them within the frame, in the
order the capture frame did. The frame's result is copied out of the pool
by `Frame.finish`, so a caller never holds a tensor that the next replay
rewrites.

Counts that a captured segment makes (`utils.profiling.count`, and
`_build.count` of its kernel launches) are tapped while it captures and
made again after every replay, a device scalar from a copy the graph
writes. Each frame counts its segments: `graph.replayed` (served by a
replay) and `graph.eager` (run on the host: not graphable, a key's first
frame, or its capture), and `graph.pool_bytes`, the bytes the pools of the
held keys reserve.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, Iterable, List, Optional

import torch
from torch.utils import _pytree as pytree

from cmtcoop_tpu_torch import _build
from cmtcoop_tpu_torch.models.layers import _pack_key
from cmtcoop_tpu_torch.utils import profiling

# keys held a detector: the batch shapes in use at one time with one set
# of weights (a key of stale weights is dropped at once)
MAX_KEYS = 4
_INTERNAL = object()  # a segment input that an earlier segment made


def _borrow(t: torch.Tensor) -> torch.Tensor:
    """A tensor on `t`'s memory that does not own it (as PyTorch's own graph
    trees hand out a graph's outputs): the memory stays the pool's, or the
    static buffer's or parameter's that `t` viewed."""
    if not t.is_cuda:
        return t
    storage = torch._C._construct_storage_from_data_pointer(
        t.untyped_storage().data_ptr(), t.device, t.untyped_storage().nbytes())
    return torch.empty(0, dtype=t.dtype, device=t.device).set_(
        storage, t.storage_offset(), t.shape, t.stride())


class _Segment:
    __slots__ = ("graph", "inputs", "outputs", "counts", "launches")


class _Tape:
    """One key's segments in frame order, their static inputs and their
    graphs' pool."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.segments: List[_Segment] = []
        self.statics: Dict[tuple, List[torch.Tensor]] = {}
        self.pool_bytes = 0


class Frame:
    """One forward's runner of segments (module docstring): `frame(fn,
    *args, **kwargs)` runs, captures or replays `fn` on the arguments.
    `finish(out)` ends the frame."""

    def __init__(self, owner: Optional["FrameGraphs"] = None,
                 mode: str = "eager", tape: Optional[_Tape] = None,
                 key=None):
        self.owner, self.mode, self.tape, self.key = owner, mode, tape, key
        self.i = 0  # segments run
        self.produced = set()  # storages of the outputs captured so far
        if mode == "capture":
            _clear_cublas_workspaces()

    def __call__(self, fn: Callable, *args, **kwargs):
        if self.mode == "replay":
            return self._replay(args, kwargs)
        if self.owner is not None:
            self.i += 1
        if self.mode == "eager":
            return fn(*args, **kwargs)
        return self._capture(fn, args, kwargs)

    # -- capture -------------------------------------------------------------
    def _static(self, x: torch.Tensor, taken: set) -> torch.Tensor:
        """A static buffer holding `x`: the tape's first of its shape and
        dtype that this segment has not `taken` and no segment returned,
        else a new one."""
        bufs = self.tape.statics.setdefault(
            (tuple(x.shape), x.dtype, x.device), [])
        for buf in bufs:
            if (id(buf) not in taken and buf.untyped_storage().data_ptr()
                    not in self.produced):
                break
        else:
            buf = torch.empty(x.shape, dtype=x.dtype, device=x.device)
            bufs.append(buf)
        taken.add(id(buf))
        return buf.copy_(x)

    def _capture(self, fn, args, kwargs):
        tape = self.tape
        leaves, spec = pytree.tree_flatten((args, kwargs))
        inputs, call, taken = [], [], set()
        for x in leaves:
            if not isinstance(x, torch.Tensor):
                inputs.append(x)
                call.append(x)
            elif x.untyped_storage().data_ptr() in self.produced:
                inputs.append(_INTERNAL)
                call.append(x)
            else:
                buf = self._static(x, taken)
                inputs.append(buf)
                call.append(buf)
        call_args, call_kwargs = pytree.tree_unflatten(call, spec)
        seg = _Segment()
        seg.inputs, seg.counts, seg.launches = inputs, [], []
        seg.graph = torch.cuda.CUDAGraph()
        stream = self.owner.stream()
        stream.wait_stream(torch.cuda.current_stream())
        profiling.RECORDER.taps.append(seg.counts)
        _build.taps.append(seg.launches)
        try:
            with torch.cuda.stream(stream):
                seg.graph.capture_begin(pool=tape.pool,
                                        capture_error_mode="thread_local")
                try:
                    out = fn(*call_args, **call_kwargs)
                finally:
                    seg.graph.capture_end()
        finally:
            profiling.RECORDER.taps.pop()
            _build.taps.pop()
        torch.cuda.current_stream().wait_stream(stream)
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.produced.add(t.untyped_storage().data_ptr())
        seg.outputs = pytree.tree_map(
            lambda t: _borrow(t) if isinstance(t, torch.Tensor) else t, out)
        tape.segments.append(seg)
        self._after_replay(seg)
        return out

    # -- replay --------------------------------------------------------------
    def _replay(self, args, kwargs):
        segments = self.tape.segments
        if self.i >= len(segments):
            raise RuntimeError("graphs: the frame runs more segments than "
                               "its key captured")
        seg = segments[self.i]
        self.i += 1
        leaves = pytree.tree_leaves((args, kwargs))
        if len(leaves) != len(seg.inputs):
            raise RuntimeError("graphs: a segment's inputs differ from the "
                               "captured ones")
        for x, want in zip(leaves, seg.inputs):
            if want is _INTERNAL:
                continue
            if isinstance(want, torch.Tensor):
                if x.shape != want.shape or x.dtype != want.dtype:
                    raise RuntimeError(
                        f"graphs: an input of shape {tuple(x.shape)} "
                        f"{x.dtype} where {tuple(want.shape)} {want.dtype} "
                        "was captured")
                want.copy_(x)
            elif x != want:
                raise RuntimeError(f"graphs: argument {x!r} where {want!r} "
                                   "was captured")
        self._after_replay(seg)
        return seg.outputs

    @staticmethod
    def _after_replay(seg: _Segment) -> None:
        seg.graph.replay()
        for name, value in seg.counts:
            if not isinstance(value, torch.Tensor):
                profiling.count(name, value)
            elif profiling.recording():
                profiling.count(name, value.clone())
        for name, shape in seg.launches:
            _build.count(name, shape)

    # -- the frame's end -----------------------------------------------------
    def finish(self, out):
        """The frame's result `out`, its tensors copied out of the graphs'
        pool on a captured or replayed frame; counts the frame."""
        if self.owner is None:
            return out
        if self.mode == "capture":
            self.owner.store(self.key, self.tape)
        elif self.mode == "replay" and self.i != len(self.tape.segments):
            raise RuntimeError("graphs: the frame ran fewer segments than its "
                               "key captured")
        if self.mode != "eager":
            out = pytree.tree_map(
                lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                out)
        replayed = self.i if self.mode == "replay" else 0
        profiling.count("graph.replayed", replayed)
        profiling.count("graph.eager", self.i - replayed)
        profiling.count("graph.pool_bytes", self.owner.pool_bytes())
        return out


EAGER = Frame()  # direct calls, counted nowhere: a module used on its own


def _clear_cublas_workspaces() -> None:
    """Drop cuBLAS's per-stream workspaces (as PyTorch's own graph trees
    do around a capture), so the capture stream's is made inside the
    capture, in the key's pool, and no workspace outlives the capture as a
    second allocation beside the one eager matmuls hold."""
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()


def _pool_bytes(pool) -> int:
    """Bytes of the segments the allocator holds for `pool`."""
    return sum(int(s["total_size"]) for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) == tuple(pool))


class FrameGraphs:
    """A detector's eval-frame graphs, held by key (module docstring)."""

    def __init__(self):
        # key -> its tape once captured, None after its first (eager) frame
        self.tapes: "collections.OrderedDict" = collections.OrderedDict()
        self._stream: Optional[torch.cuda.Stream] = None

    def __deepcopy__(self, memo) -> "FrameGraphs":
        return FrameGraphs()  # a copied model captures anew

    def frame(self, batch: Dict[str, object],
              modules: Iterable[torch.nn.Module], graphable: bool) -> Frame:
        """The runner of one forward on `batch`, whose graphed segments run
        `modules`; eager where not `graphable`."""
        if not graphable:
            return Frame(self)
        inputs = tuple(sorted((k, tuple(v.shape), v.dtype, v.device)
                              for k, v in batch.items()
                              if isinstance(v, torch.Tensor)))
        weights = tuple(_pack_key(None, *(t for m in modules
                                          for t in (*m.parameters(),
                                                    *m.buffers()))))
        key = (inputs, weights)
        if key not in self.tapes:
            for old in [k for k in self.tapes if k[1] != weights]:
                del self.tapes[old]  # weights changed: never seen again
            self.tapes[key] = None
            while len(self.tapes) > MAX_KEYS:
                self.tapes.popitem(last=False)
            return Frame(self, key=key)
        self.tapes.move_to_end(key)
        tape = self.tapes[key]
        if tape is None:
            return Frame(self, "capture", _Tape(), key)
        return Frame(self, "replay", tape, key)

    def store(self, key, tape: _Tape) -> None:
        _clear_cublas_workspaces()
        if key in self.tapes:
            tape.pool_bytes = _pool_bytes(tape.pool)
            self.tapes[key] = tape

    def pool_bytes(self) -> int:
        return sum(t.pool_bytes for t in self.tapes.values() if t is not None)

    def stream(self) -> torch.cuda.Stream:
        """The side stream graphs capture on (CUDA captures no legacy
        default stream)."""
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        return self._stream
