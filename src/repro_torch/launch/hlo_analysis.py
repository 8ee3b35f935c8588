"""Per-device cost of one step, counted on the local shards, after the JAX
package's ``launch/hlo_analysis.py``.

The reference reads its costs from the partitioned HLO text of a compiled
step: ``analyze_hlo`` walks the module, expands ``while`` bodies by their
trip counts (``cost_analysis()`` counts a scanned layer stack once) and
counts an in-place dynamic-update-slice by its update. The port has no
HLO and no such walker: its loops are Python, so a traced step runs every
layer and every chunk. Its counterpart is :class:`CostCounter`, a
``TorchDispatchMode`` that fills the same record, :class:`HloCost`, while
the step runs (on fake tensors over a fake process group in the dry run,
:mod:`repro_torch.launch.dryrun`, or on real tensors on the card). Two
loops are counted by their trip counts, the counterpart of the reference's
``known_trip_count`` expansion: the sLSTM scan over time and the mLSTM
chunk loop (:mod:`repro_torch.models.ssm`; 32,768 and 128 trips at
prefill_32k). On fake tensors under an active counter their body runs once
for all the trips between the first and the last (:func:`run_trips`),
forward and backward, and ``CostCounter.repeated`` counts that run so many
times; the count equals the full loop's. On real tensors every trip runs.

  * flops      -- the matmul-class ops, by the formulas that
    ``torch.utils.flop_counter`` registers (mm, addmm, bmm, baddbmm,
    convolutions, scaled-dot-product attention), applied to the shapes the
    op runs at on this device. A DTensor op is not counted itself: the
    counter steps aside (``NotImplemented``), DTensor runs the op on the
    local shards, and the counter counts that local op. ``local_map``
    bodies run on local tensors and are counted the same way. (torch's
    ``FlopCounterMode`` counts a DTensor op at its global shapes and a
    ``local_map`` body at its local ones, so its total is neither the
    global nor the per-device count.) Elementwise FLOPs are ignored, as
    the reference ignores them. The ops DTensor runs at the global shapes
    to propagate an output's shape are not counted;
  * mem_bytes  -- 2 x the result bytes of every local op that is not a
    view or an allocation: a read-plus-write proxy for HBM traffic. It is
    not comparable to the reference's count: XLA fuses elementwise chains
    and counts a fusion's result once, while eager PyTorch writes every
    intermediate, so this count is larger for the same step. A
    hand-written kernel launched through ctypes reaches no dispatcher: its
    wrapper counts it with :func:`count_kernel`, by the bytes it reads and
    writes (AdamW's leaf kernel, :mod:`repro_torch.kernels.adamw`, on real
    tensors and on fake CUDA stand-ins alike);
  * coll_bytes -- the collectives that reach the dispatcher: the
    ``_c10d_functional`` ops (DTensor's redistributions: all-gather,
    all-reduce, reduce-scatter, all-to-all) and the ``c10d`` ops that
    ``torch.distributed``'s calls issue (MoE's all-to-all, Adafactor's
    all-reduced means, the sequence-split decode cache's all-reduces),
    each from its local result bytes and its group size, with the
    reference's ring multipliers (:func:`repro_torch.launch.roofline.ring_bytes`).

``CostCounter.by_op`` keeps calls, FLOPs and bytes per op, so that a
difference between two counts can be explained; ``CostCounter.records``
keeps ``(op, local result bytes, group size)`` per collective, the input of
:func:`repro_torch.launch.roofline.collective_bytes`.
"""

from __future__ import annotations

import contextlib
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils.flop_counter import flop_registry

from .roofline import COLLECTIVES as _COLLECTIVES
from .roofline import ring_bytes

__all__ = ["CostCounter", "HloCost", "count_kernel", "run_trips", "trip_counters"]


@dataclass
class HloCost:
    flops: float = 0.0
    mem_bytes: float = 0.0
    coll_bytes: Dict[str, float] = field(default_factory=lambda: {c: 0.0 for c in _COLLECTIVES})
    coll_counts: Dict[str, int] = field(default_factory=lambda: {c: 0 for c in _COLLECTIVES})

    @property
    def coll_total(self) -> float:
        return float(sum(self.coll_bytes.values()))

    def add(self, other: "HloCost", mult: float = 1.0, mem: bool = True):
        self.flops += mult * other.flops
        if mem:
            self.mem_bytes += mult * other.mem_bytes
        for c in _COLLECTIVES:
            self.coll_bytes[c] += mult * other.coll_bytes[c]
            self.coll_counts[c] += int(mult * other.coll_counts[c])


# collective ops -> the reference's op; a functional op's local result is
# its output, a c10d op's the tensor(s) it writes in place (its first
# argument)
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_C10D = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
}
# allocations, and the wait on a collective: no memory traffic
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided", "wait_tensor"}


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    return []


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _group_size(args, kwargs) -> int:
    """The size of the process group an op names: an explicit
    ``group_size``, a ``group_name``, or a ``ProcessGroup`` argument."""
    import torch.distributed as dist

    if "group_size" in kwargs:
        return int(kwargs["group_size"])
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.ScriptObject):
            return dist.ProcessGroup.unbox(a).size()
    name = kwargs.get("group_name", args[-1])
    return torch._C._distributed_c10d._resolve_process_group(name).size()


def _collective(func, args, kwargs, out):
    """``(op, local result bytes, group size)`` of a collective, else
    ``None``."""
    ns, name = func.namespace, func._schema.name.split("::")[-1]
    if ns == "_c10d_functional" and name in _FUNCTIONAL:
        op = _FUNCTIONAL[name]
        if name.startswith(("all_gather_into_tensor", "reduce_scatter_tensor")):
            n = int(args[1] if name.startswith("all_gather") else args[2])
        else:
            n = _group_size(args, kwargs)
        return op, _nbytes(out), n
    if ns == "c10d" and name in _C10D:
        return _C10D[name], _nbytes(args[0]), _group_size(args, kwargs)
    return None


_PROPAGATION_FILE = os.path.join("distributed", "tensor", "_sharding_prop.py")


def _in_shape_propagation() -> bool:
    """Whether the op runs inside DTensor's sharding propagation, which
    runs each DTensor op once more on fake tensors of the global shapes to
    learn its output's shape (under the active fake mode, on the mesh's
    device type). Those runs are no part of the step: they are told apart
    by a frame of ``torch/distributed/tensor/_sharding_prop.py`` on the
    Python stack."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATION_FILE):
            return True
        f = f.f_back
    return False


class CostCounter(TorchDispatchMode):
    """Counts the per-device cost of what runs under it into ``cost`` (an
    :class:`HloCost`), ``by_op`` (``{op: [calls, flops, mem_bytes]}``) and
    ``records`` (one ``(op, local result bytes, group size)`` per
    collective). See the module docstring for what is counted."""

    def __init__(self):
        super().__init__()
        self.cost = HloCost()
        self.by_op: Dict[str, list] = {}
        self.records: List[Tuple[str, int, int]] = []
        self.trips = 1

    @contextlib.contextmanager
    def repeated(self, trips: int):
        """Counts every op that runs under it ``trips`` times (in ``cost``,
        ``by_op`` and ``records``): a loop body run once for all its trips."""
        prev = self.trips
        self.trips = prev * trips
        try:
            yield
        finally:
            self.trips = prev

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it on the local shards, which come back here
        packet = func.overloadpacket
        if packet not in flop_registry and func is not torch.ops.prim.device.default:
            with self:  # a composite op (matmul, einsum under inference mode): count its parts
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        if func is torch.ops.prim.device.default or _in_shape_propagation():
            return out
        trips = self.trips
        flops = float(flop_registry[packet](*args, **kwargs, out_val=out)) * trips if packet in flop_registry else 0.0
        coll = _collective(func, args, kwargs, out)
        mem = 0.0
        if coll is not None:
            op, size, n = coll
            self.records.extend([coll] * trips)
            self.cost.coll_bytes[op] += trips * ring_bytes(op, size, n)
            self.cost.coll_counts[op] += trips
            mem = 2.0 * size * trips
        elif not func.is_view and func._schema.name.split("::")[-1] not in _NO_TRAFFIC:
            mem = 2.0 * _nbytes(out) * trips
        self.cost.flops += flops
        self.cost.mem_bytes += mem
        entry = self.by_op.setdefault(str(func), [0, 0.0, 0.0])
        entry[0] += trips
        entry[1] += flops
        entry[2] += mem
        return out


def count_kernel(name: str, mem_bytes: float, flops: float = 0.0) -> None:
    """Counts one launch of the hand-written kernel ``name``, which moves
    ``mem_bytes`` and computes ``flops``, into every active
    :class:`CostCounter` (in ``cost`` and ``by_op``, times its trips)."""
    for c in _get_current_dispatch_mode_stack():
        if isinstance(c, CostCounter):
            c.cost.flops += flops * c.trips
            c.cost.mem_bytes += mem_bytes * c.trips
            entry = c.by_op.setdefault(name, [0, 0.0, 0.0])
            entry[0] += c.trips
            entry[1] += flops * c.trips
            entry[2] += mem_bytes * c.trips


def trip_counters(*tensors) -> list:
    """The active :class:`CostCounter` modes when every one of ``tensors``
    is a fake tensor (a dry run's trace), else ``[]``: where a loop may be
    counted by its trip count. On real tensors every trip runs."""
    from torch._subclasses.fake_tensor import FakeTensor

    if not tensors or not all(isinstance(t, FakeTensor) for t in tensors):
        return []
    return [m for m in _get_current_dispatch_mode_stack() if isinstance(m, CostCounter)]


@contextlib.contextmanager
def _repeated(counters, trips):
    with contextlib.ExitStack() as stack:
        for c in counters:
            stack.enter_context(c.repeated(trips))
        yield


def _same(x):
    return x


class _Trips(torch.autograd.Function):
    """One trip of a loop body, counted as ``trips`` trips forward and
    backward. The forward runs the body on detached leaves under grad mode
    and keeps that graph (saved tensors kept as they are, out of reach of
    an enclosing checkpoint's hooks); the backward runs the graph's
    backward under the same count. The autograd engine sums the trips'
    gradients of an input that every trip reads (the first ``n_shared``):
    ``trips - 1`` adds of its size, counted so (the values are fake)."""

    @staticmethod
    def forward(ctx, counters, trips, body, n_shared, *args):
        ctx.set_materialize_grads(False)
        leaves = [a.detach().requires_grad_(a.requires_grad) for a in args]
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(_same, _same), \
                _repeated(counters, trips):
            outs = body(*leaves)
        ctx.run = (counters, trips, n_shared, leaves, outs)
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        counters, trips, n_shared, leaves, outs = ctx.run
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
        want = [i for i, x in enumerate(leaves) if x.requires_grad]
        with _repeated(counters, trips):
            got = torch.autograd.grad([o for o, _ in pairs], [leaves[i] for i in want], [g for _, g in pairs],
                                      allow_unused=True)
        out = [None] * len(leaves)
        for i, g in zip(want, got):
            if g is not None and i < n_shared:
                with _repeated(counters, trips - 1):
                    g = g + g
            out[i] = g
        return (None, None, None, None, *out)


def run_trips(counters, trips: int, body, shared, carried) -> tuple:
    """``body(*shared, *carried)``, a loop body whose ops are the same at
    every trip, run once and counted ``trips`` times by ``counters``
    (:func:`trip_counters`), its backward too under grad mode. ``shared``
    are the inputs every trip reads, ``carried`` the state one trip hands
    the next; the body returns a tuple of tensors."""
    args = (*shared, *carried)
    if not (torch.is_grad_enabled() and any(a.requires_grad for a in args)):
        with _repeated(counters, trips):
            return tuple(body(*args))
    return _Trips.apply(counters, trips, body, len(shared), *args)

