"""Cost of one step from a walk of the ATen ops it runs: the port's
counterpart of ``repro.perf.hlo_analysis``.

The reference parses the optimized XLA HLO text of a compiled step and
multiplies each loop body by its trip count. The port has no compiled
module to parse: ``analyze(fn, *args)`` runs the step once, eagerly, under
a ``TorchDispatchMode`` and counts every op as it runs, so every loop is
counted at its real trip count. A captured CUDA graph replays the launches
of the eager step it captured, bitwise (``runtime.steps.CapturedStep``),
so the walk of the eager step stands for the replay too. It counts, with
the reference's field names and conventions:

* ``dot_flops``: 2 * prod(result) * prod(contracted dims) for every mm,
  bmm, addmm, baddbmm, mv, dot and convolution (a convolution's backward
  counts one forward for each gradient it computes);
* ``traffic_bytes``: operand + result bytes of every op that materialises
  a tensor (the reference's HloCostAnalysis proxy for memory traffic).
  Views and metadata ops do not count, nor an ``empty`` allocation. As
  the reference counts a dynamic slice and a dynamic update slice by the
  slice, a gather (``index``, ``index_select``, ``gather``,
  ``embedding``) counts the rows it reads and writes and its index, and
  an in-place scatter (``index_put_``, ``index_copy_``, ``index_add_``,
  ``scatter_``) the rows it writes (read too when it accumulates) and its
  index, not the whole tensor it writes into; a ``copy_`` or ``fill_``
  does not read what it overwrites;
* ``collective_bytes``: operand bytes entering every c10d or functional
  collective, by the reference's kinds (``all-reduce``, ``all-gather``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``; plus
  ``broadcast``). On one card there are none.

The port's kernels are not ATen ops: each is an ``nvcc``-built library
called through ``ctypes``, which a dispatch mode never sees. So each
kernel wrapper reports its own work to the walk
(``kernels._build.reports_work``): its dot flops are those its plain
version performs at the same shapes, and its bytes are its operands plus
its result (the convention a custom call gets in the reference's walk,
and the one ``chip_smoke.py``'s ``bound_ms`` uses). On the CPU, where the
wrapper runs that plain version, the plain version's own ops run outside
the walk, so a step reads the same work whichever implementation ran.
Each report is also counted as one launch of that kernel
(``OpCost.kernel_launches``).

Over ``DTensor``s (the dry run's stand-ins on a fake process group) the
walk counts one device, rank 0, as the reference's per-device SPMD module
does: an op whose arguments include a ``DTensor`` is handed back to
``DTensor`` (the walk returns ``NotImplemented``, as
``torch.distributed.tensor.debug.CommDebugMode`` does), which breaks it
into the local op on the shards and the collectives of any redistribute,
and the walk counts those. The ops ``DTensor``'s sharding propagation
runs on ``FakeTensor``s of the global shape are not counted. A
collective that ``DTensor`` issues on its own, to bring an op's
arguments into a placement its strategy can run, is also kept by the op
and the port's line that called it (``OpCost.implicit``): where it is an
all-gather, that op runs on gathered, replicated inputs, the dry run's
record of what ``DTensor`` had to replicate. On a CPU device mesh
``DTensor`` runs a shard-to-shard all-to-all as an all-gather and a chunk
(Gloo has no all-to-all); the walk counts it as the all-to-all.

Memory, the counterpart of XLA's ``memory_analysis()``, in bytes of the
local shards: ``argument_bytes`` (what the inputs hold),
``output_bytes`` (what the outputs hold) and ``peak_live_bytes`` (the
most bytes alive at once, the inputs included). Live memory is kept per
storage, keyed by identity (a view adds nothing) and released by a weakref
when the storage dies; a ``meta`` storage has its ``nbytes``, so a walk
of stand-ins reads what the real tensors would hold.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import sys
import weakref
from collections import defaultdict
from typing import Callable

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVE_KINDS = (
    ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
    ("all_gather", "all-gather"), ("allgather", "all-gather"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
    ("send", "collective-permute"), ("recv", "collective-permute"),
    ("broadcast", "broadcast"),
)
COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
# allocations, and ``_unsafe_view`` (a view whose schema does not mark its
# result as an alias): no bytes move
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "lift_fresh", "_local_scalar_dense", "_unsafe_view"}
_DOTS = {"mm", "bmm", "addmm", "baddbmm", "mv", "addmv", "dot", "convolution",
         "convolution_backward"}
# (op, index of its rows argument) of the gathers: they read what they write
_GATHERS = {"index": 0, "_unsafe_index": 0, "index_select": 0, "gather": 0, "embedding": 0}
# in-place scatters: (index of the rows written, whether they are read too)
_SCATTERS = {"index_put_": (2, False), "_index_put_impl_": (2, False),
             "index_copy_": (3, False), "index_add_": (3, True), "scatter_": (3, False),
             "scatter_add_": (3, True), "scatter_reduce_": (3, True)}
_OVERWRITES = {"copy_", "fill_", "zero_"}
_TRANSCENDENTAL = {"exp", "exp_", "exp2", "expm1", "log", "log_", "log1p", "log2", "tanh",
                   "tanh_", "rsqrt", "rsqrt_", "sqrt", "sqrt_", "pow", "pow_", "sigmoid",
                   "sigmoid_", "silu", "silu_", "_softmax", "_log_softmax", "erf", "gelu"}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes a tensor's elements span: its element count, or the span of
    its strides where that is smaller (an expanded view reads its storage
    once)."""
    if t.numel() == 0:
        return 0
    span = 1 + sum((n - 1) * abs(s) for n, s in zip(t.shape, t.stride()))
    return min(t.numel(), span) * t.element_size()


def _tensors(x) -> list[torch.Tensor]:
    """The tensors in ``x``, a ``DTensor`` as its local shard: the walk
    counts one device's work, as the reference's per-device HLO does."""
    return [getattr(t, "_local_tensor", t) for t in tree_leaves(x)
            if isinstance(t, torch.Tensor)]


def _shapes(args) -> str:
    return " ".join("x".join(map(str, t.shape)) or "()" for t in _tensors(args))


def _dot_flops(name: str, args, out) -> float:
    if name in ("convolution", "convolution_backward"):
        w = args[1] if name == "convolution" else args[2]
        per = math.prod(w.shape[1:])
        if name == "convolution":
            return 2.0 * out.numel() * per
        mask = args[-1]
        return 2.0 * args[0].numel() * per * sum(bool(m) for m in mask[:2])
    lhs = args[1] if name in ("addmm", "baddbmm", "addmv") else args[0]
    return 2.0 * out.numel() * lhs.shape[-1]


@dataclasses.dataclass
class OpCost:
    """What one walk counted: the reference's ``HloCost`` fields, the
    kernels' reported launches, and per (op, operand shapes) rows for
    ``top_contributors``."""

    dot_flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: dict[str, float] = dataclasses.field(default_factory=dict)
    transcendentals: float = 0.0
    kernel_launches: dict[str, int] = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_live_bytes: int = 0
    # "kind: aten op at file:function" -> operand bytes of the collectives
    # DTensor issued on its own to run that op
    implicit: dict[str, float] = dataclasses.field(default_factory=dict)
    # (op, shapes) -> [calls, dot_flops, traffic_bytes, collective_bytes]
    rows: dict[tuple[str, str], list[float]] = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: [0, 0.0, 0.0, 0.0]))

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def _add(self, op: str, shapes: str, flops=0.0, traffic=0.0, coll=0.0) -> None:
        self.dot_flops += flops
        self.traffic_bytes += traffic
        row = self.rows[op, shapes]
        row[0] += 1
        row[1] += flops
        row[2] += traffic
        row[3] += coll

    def count_op(self, func, args, kwargs, out, dtensor_op: str = "") -> None:
        """Count one ATen op as it ran (``dtensor_op``: the last op that
        ``DTensor`` took, to which a collective it issues belongs)."""
        name = func._schema.name.split("::")[-1]
        if func.namespace in COLLECTIVE_NAMESPACES:
            kind = next((k for key, k in COLLECTIVE_KINDS if key in name), None)
            if kind is None:
                return  # wait_tensor, barrier: no operand enters a network
            first = func._schema.arguments[0].name if func._schema.arguments else ""
            operand = args[1] if first.startswith("output") else args[0]
            b = sum(tensor_bytes(t) for t in _tensors(operand))
            alltoall, implicit, site = _collective_origin()
            kind = "all-to-all" if alltoall else kind
            self.collective_bytes[kind] = self.collective_bytes.get(kind, 0.0) + b
            self._add(f"{func.namespace}.{name}", _shapes(operand), coll=b)
            if implicit:
                key = f"{kind}: {dtensor_op} at {site}"
                self.implicit[key] = self.implicit.get(key, 0.0) + b
            return
        returns = func._schema.returns
        outs = _tensors(out)
        if not outs or name in _NO_TRAFFIC:
            return
        if any(r.alias_info is not None and not r.alias_info.is_write for r in returns):
            return  # a view
        if name in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        shapes = _shapes(args)
        flops = _dot_flops(name, args, out) if name in _DOTS else 0.0
        if name in _GATHERS:
            rows = args[_GATHERS[name]]
            idx = [t for t in _tensors((args, kwargs)) if t is not rows]
            traffic = 2 * sum(map(tensor_bytes, outs)) + sum(map(tensor_bytes, idx))
        elif name in _SCATTERS:
            pos, reads = _SCATTERS[name]
            rows = args[pos] if len(args) > pos and isinstance(args[pos], torch.Tensor) else None
            idx = [t for t in _tensors(args[1:pos]) if t is not rows]
            written = tensor_bytes(rows) if rows is not None else sum(map(tensor_bytes, idx))
            traffic = (3 if reads else 2) * written + sum(map(tensor_bytes, idx))
        elif name in _OVERWRITES:
            traffic = sum(tensor_bytes(t) for t in _tensors(args[1:])) + sum(
                map(tensor_bytes, outs))
        else:
            traffic = sum(tensor_bytes(t) for t in _tensors((args, kwargs))) + sum(
                map(tensor_bytes, outs))
        self._add(name, shapes, flops, traffic)

    def count_kernel(self, name: str, flops: float, args, kwargs, out) -> None:
        """Count one reported kernel launch: its plain version's dot flops
        and its operand + result bytes."""
        traffic = sum(tensor_bytes(t) for t in _tensors((args, kwargs)) + _tensors(out))
        self.kernel_launches[name] = self.kernel_launches.get(name, 0) + 1
        self._add(f"kernel:{name}", _shapes(args), flops, traffic)


_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_OWN = (os.path.abspath(__file__), os.path.join(_PKG, "kernels", "_build.py"))


def _collective_origin() -> tuple[bool, bool, str]:
    """(a CPU mesh's all-to-all run as an all-gather, issued by
    ``DTensor``'s own dispatch, the port's innermost calling line as
    "file:function") of the collective being counted, from the stack."""
    alltoall = implicit = False
    site = ""
    frame = sys._getframe(2)
    while frame is not None:
        code = frame.f_code
        if code.co_name == "shard_dim_alltoall":
            alltoall = True
        elif code.co_filename.endswith(os.path.join("distributed", "tensor", "_dispatch.py")):
            implicit = True
        elif not site and code.co_filename.startswith(_PKG) and code.co_filename not in _OWN:
            site = f"{os.path.relpath(code.co_filename, _PKG)}:{code.co_name}"
        frame = frame.f_back
    return alltoall, implicit, site


def _storages(x) -> dict[int, torch.UntypedStorage]:
    """The distinct storages of the tensors in ``x`` (a ``DTensor``'s
    local shard's; a module's parameters and buffers), keyed by identity."""
    out = {}
    mods = [m for m in tree_leaves(x) if isinstance(m, torch.nn.Module)]
    for t in _tensors(x) + _tensors([dict(m.state_dict(keep_vars=True)) for m in mods]):
        st = t.untyped_storage()
        out.setdefault(st._cdata, st)
    return out


def storage_bytes(x) -> int:
    """Bytes of the distinct storages of the tensors in ``x``."""
    return sum(st.nbytes() for st in _storages(x).values())


class _LiveBytes:
    """Bytes of the storages alive since the walk saw them, and their
    peak: a storage is added once (a view of it adds nothing) and taken
    off by a weakref when it dies."""

    def __init__(self) -> None:
        self.now = self.peak = 0
        self._refs: dict[int, weakref.ref] = {}

    def add(self, x) -> None:
        for key, st in _storages(x).items():
            if key in self._refs:
                continue
            n = st.nbytes()
            self._refs[key] = weakref.ref(st, functools.partial(self._free, key, n))
            self.now += n
        self.peak = max(self.peak, self.now)

    def _free(self, key: int, n: int, _ref) -> None:
        if self._refs.pop(key, None) is not None:
            self.now -= n


class _Walk(TorchDispatchMode):
    def __init__(self, cost: OpCost):
        super().__init__()
        self.cost = cost
        self.live = _LiveBytes()
        self.dtensor_op = ""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            self.dtensor_op = str(func.overloadpacket)
            return NotImplemented  # DTensor runs it as local ops and collectives
        out = func(*args, **kwargs)
        if not any(issubclass(t, FakeTensor) for t in types) and not any(
                isinstance(t, FakeTensor) for t in tree_leaves(out)):
            self.cost.count_op(func, args, kwargs, out, self.dtensor_op)
            self.live.add(out)
        return out

    def report_kernel(self, name: str, flops: float, args, kwargs, out) -> None:
        """A kernel wrapper's report (``kernels._build.reports_work``)."""
        self.cost.count_kernel(name, flops, args, kwargs, out)
        self.live.add(out)


def analyze(fn: Callable, *args, **kwargs) -> OpCost:
    """Run ``fn(*args, **kwargs)`` once and return what it cost. The walk
    is a dispatch mode: it sees the ops and the kernel reports of the
    calling thread and of the autograd threads that run its backward, and
    nothing of another thread. The inputs' bytes are those of ``args``
    and ``kwargs``, the outputs' those of what ``fn`` returns."""
    cost = OpCost()
    walk = _Walk(cost)
    cost.argument_bytes = storage_bytes((args, kwargs))
    walk.live.add((args, kwargs))
    with walk:
        out = fn(*args, **kwargs)
    cost.output_bytes = storage_bytes(out)
    cost.peak_live_bytes = walk.live.peak
    return cost


def top_contributors(cost: OpCost, metric: str = "traffic", n: int = 20) -> list[tuple]:
    """The ``n`` largest contributors by ``metric`` ('traffic',
    'dot_flops' or 'collective'): rows of (value, op, operand shapes,
    calls), each (op, shapes) summed over its calls."""
    col = {"dot_flops": 1, "traffic": 2, "collective": 3}[metric]
    rows = [(v[col], op, shapes, int(v[0])) for (op, shapes), v in cost.rows.items() if v[col]]
    rows.sort(key=lambda r: -r[0])
    return rows[:n]
