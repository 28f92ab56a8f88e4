"""Cost of one step from the ops it dispatches.

The reference parses the optimized, partitioned HLO of a compiled step and
walks its call graph with while-loop trip counts. PyTorch runs eagerly and
has no HLO: here a :class:`CostCounter` (a ``TorchDispatchMode``) counts the
ATen and c10d ops that one rank's step dispatches, the backward's and the
recompute of ``torch.utils.checkpoint`` included. On ``meta`` tensors (or
under ``FakeTensorMode``) and a ``fake`` process group the step runs at
production shapes with nothing allocated
(:mod:`repro_torch.launch.dryrun`); on real tensors the same counter counts
a step that runs.

* **flops**: ``2 * result_elems * contracted_elems`` per matrix product
  (``mm``, ``addmm``, ``bmm``, ``baddbmm``: what ``matmul``, ``linear`` and
  ``einsum`` dispatch), from ``torch.utils.flop_counter``'s formulas; one
  flop an element for the ops of :data:`ELEMENTWISE_FLOP_OPS` and for each
  element a reduction reads (reported separately);
* **bytes**: operand bytes + result bytes per op at the dtype the op runs
  in (the reference caps f32 at 2 B because CPU-XLA promotes bf16 to f32;
  eager PyTorch does not promote). Views and metadata ops
  (:data:`FREE_OPS`) are free. In-place writes into a buffer
  (:data:`UPDATE_OPS`: ``copy_``, ``index_copy_``, ``index_put_``,
  ``scatter_``, ``slice_scatter``) are charged twice the update's bytes
  (read it, write it), not the buffer's: the reference's
  dynamic-update-slice rule. Eager runs no fusion, so the bytes are an
  upper bound, as the reference's CPU-fusion bytes are;
  :func:`repro_torch.core.roofline.memory_floor_s` is the lower bound;
* **collective bytes**: operand bytes per collective type
  (:data:`COLLECTIVE_OPS`) at the dtype on the wire (an ``f8`` all-to-all
  moves 1 B an element); an all-gather is charged its local shard;
* **hand-written kernels**: a ``ctypes`` launch is invisible to a dispatch
  mode, so each kernel wrapper calls :func:`charge_kernel` with the work
  its launch does (the formulas of ``repro_torch.kernels``), recorded under
  the kernel's name in ``dot_table`` / ``bytes_table``;
* **memory** (the counterpart of XLA's ``memory_analysis()``): the bytes of
  the step's arguments and outputs, and the peak of the live bytes of the
  storages the step creates, each freed when its last reference dies.

Eager runs every layer, so there are no trip counts to recover.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

COLLECTIVE_OPS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute", "ragged-all-to-all",
)


def _packets(*names: str) -> frozenset:
    """The ATen overload packets of ``names`` that this torch has."""
    return frozenset(getattr(aten, n) for n in names if hasattr(aten, n))


#: the counterparts of the reference's HLO elementwise ops (each with its
#: in-place form): one flop an element of the result
ELEMENTWISE_FLOP_OPS = _packets(
    "add", "add_", "sub", "sub_", "rsub", "mul", "mul_", "div", "div_",
    "maximum", "minimum", "clamp_min", "clamp_max", "exp", "exp_", "expm1",
    "log", "log_", "rsqrt", "rsqrt_", "sqrt", "sqrt_", "tanh", "tanh_",
    "sigmoid", "sigmoid_", "pow", "pow_", "cos", "sin", "neg", "neg_",
    "abs", "abs_", "atan2", "addcmul", "addcmul_", "lerp_")

#: reductions: one flop an element they read (the reference's ``reduce``)
REDUCE_OPS = _packets("sum", "mean", "amax", "amin", "max", "min", "prod",
                      "logsumexp", "norm", "linalg_vector_norm")

#: views, metadata and allocation: no bytes move (the reference's
#: ``FREE_OPS``). ``reshape`` and ``narrow`` never reach a dispatch mode:
#: they arrive as a view (free) or, off a non-contiguous tensor, as a
#: ``clone`` (charged)
FREE_OPS = _packets(
    "view", "_unsafe_view", "_reshape_alias", "t", "transpose", "permute",
    "expand", "slice", "select", "as_strided", "detach", "alias",
    "unsqueeze", "squeeze", "split", "split_with_sizes", "unbind",
    "diagonal", "view_as_real", "view_as_complex", "lift_fresh", "unfold",
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_local_scalar_dense", "is_same_size", "resolve_conj", "resolve_neg")

#: in-place writes into a buffer: (index of the update among the args,
#: indices of the args read besides it). Charged ``2 * update`` + reads.
UPDATE_OPS = {
    aten.copy_: (1, ()),
    aten.index_copy_: (3, (2,)),
    aten.index_copy: (3, (2,)),
    aten.index_put_: (2, (1,)),
    aten.index_put: (2, (1,)),
    aten._index_put_impl_: (2, (1,)),
    aten.scatter_: (3, (2,)),
    aten.scatter: (3, (2,)),
    aten.slice_scatter: (1, ()),
    aten.select_scatter: (1, ()),
}

#: c10d ops (the process-group calls ``torch.distributed`` makes) and the
#: functional collectives: (collective type, index of the argument whose
#: tensors go on the wire). An all-gather is charged its input, the local
#: shard; a reduce-scatter its input, the whole operand
_C10D_KINDS = {
    "allreduce_": ("all-reduce", 0), "allreduce_coalesced_": ("all-reduce", 0),
    "_allgather_base_": ("all-gather", 1), "allgather_": ("all-gather", 1),
    "allgather_coalesced_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_base_": ("all-to-all", 1), "alltoall_": ("all-to-all", 1),
    "send": ("collective-permute", 0),
}
_FUNCTIONAL_KINDS = {
    "all_reduce": ("all-reduce", 0), "all_reduce_": ("all-reduce", 0),
    "all_reduce_coalesced": ("all-reduce", 0),
    "all_gather_into_tensor": ("all-gather", 0),
    "all_gather_into_tensor_coalesced": ("all-gather", 0),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "all_to_all_single": ("all-to-all", 0),
}


#: the namespaces whose ops :attr:`CostCounter.ops` counts (a fake tensor
#: also dispatches ``prim.device`` for its device, which moves nothing)
_COUNTED_NAMESPACES = ("aten", "c10d", "_c10d_functional")


def _collective(func):
    """``(collective type, wire argument index)`` of a c10d or functional
    collective op, else ``None``."""
    ns = func.namespace
    if ns not in ("c10d", "_c10d_functional"):
        return None
    name = func._schema.name.split("::", 1)[-1]
    return (_C10D_KINDS if ns == "c10d" else _FUNCTIONAL_KINDS).get(name)


def _tensors(x) -> List[torch.Tensor]:
    leaves, _ = tree_flatten(x)
    return [t for t in leaves if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _shape(t: torch.Tensor) -> str:
    return "[" + ",".join(str(int(s)) for s in t.shape) + "]"


@dataclass
class CostTotals:
    dot_flops: float = 0.0
    elementwise_flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, float] = field(default_factory=dict)
    dot_table: Dict[str, float] = field(default_factory=dict)
    bytes_table: Dict[str, float] = field(default_factory=dict)

    @property
    def flops(self) -> float:
        return self.dot_flops + self.elementwise_flops

    @property
    def collective_total(self) -> float:
        return sum(self.collective_bytes.values())

    def to_dict(self) -> Dict:
        top = dict(sorted(self.dot_table.items(), key=lambda kv: -kv[1])[:12])
        return {"flops": self.flops, "dot_flops": self.dot_flops,
                "elementwise_flops": self.elementwise_flops,
                "bytes_accessed": self.bytes_accessed,
                "collective_bytes": dict(self.collective_bytes),
                "collective_counts": dict(self.collective_counts),
                "collective_total": self.collective_total,
                "top_dots": top}


def _add(table: Dict[str, float], key: str, v: float) -> None:
    table[key] = table.get(key, 0.0) + v


#: the counters active now, innermost last (a kernel launch charges each)
_ACTIVE: List["CostCounter"] = []


def charge_kernel(name: str, work: Callable[[], Tuple[float, float]]
                  ) -> None:
    """Charge every active :class:`CostCounter` with one launch of the
    hand-written kernel ``name``: ``work()`` gives its matrix-product
    flops and the bytes it moves, and is called only while a counter is
    active (kernel wrappers call this where they launch, and a launch
    outside a count pays no host time for it)."""
    if _ACTIVE:
        flops, bytes_accessed = work()
        for c in _ACTIVE:
            c.charge(name, flops, bytes_accessed)


class CostCounter(TorchDispatchMode):
    """Counts every op dispatched while it is entered into :attr:`totals`
    (a :class:`CostTotals`) and :attr:`ops` (the number of ops). On
    ``meta`` tensors, or stacked inside ``FakeTensorMode``, it counts a
    step that allocates nothing; the ops reach it before the fake mode, the
    backward's and a checkpoint's recompute included.

    :meth:`arguments` marks the step's inputs; the storages created after
    are the intermediates whose live bytes :attr:`peak_temp_bytes` tracks.
    """

    def __init__(self) -> None:
        super().__init__()
        self.totals = CostTotals()
        self.ops = 0
        self.kernel_launches: Dict[str, int] = {}
        #: elementwise flops by op (``CostTotals`` keeps the reference's
        #: fields, which have no such table)
        self.elementwise_table: Dict[str, float] = {}
        self.argument_bytes = 0
        self.live_temp_bytes = 0
        self.peak_temp_bytes = 0
        self._known: Dict[int, int] = {}

    # ------------------------------------------------------------ memory
    def arguments(self, *args: Any) -> None:
        """Mark the storages of ``args``' tensors as arguments."""
        for t in _tensors(args):
            st = t.untyped_storage()
            if id(st) not in self._known:
                self._known[id(st)] = 0
                weakref.finalize(st, self._known.pop, id(st), None)
                self.argument_bytes += st.nbytes()

    def _track(self, out: Any) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            if id(st) in self._known:
                continue
            n = st.nbytes()
            self._known[id(st)] = n
            self.live_temp_bytes += n
            self.peak_temp_bytes = max(self.peak_temp_bytes,
                                       self.live_temp_bytes)
            weakref.finalize(st, self._free, id(st))

    def _free(self, key: int) -> None:
        self.live_temp_bytes -= self._known.pop(key, 0)

    # ------------------------------------------------------------ counting
    def charge(self, name: str, flops: float, bytes_accessed: float) -> None:
        """One launch of a hand-written kernel (see :func:`charge_kernel`).
        """
        tot = self.totals
        tot.dot_flops += flops
        _add(tot.dot_table, name, flops)
        tot.bytes_accessed += bytes_accessed
        _add(tot.bytes_table, name, bytes_accessed)
        self.kernel_launches[name] = self.kernel_launches.get(name, 0) + 1

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in _COUNTED_NAMESPACES:
            self.ops += 1
        self._count(func, args, kwargs, out)
        self._track(out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        tot = self.totals
        packet = func.overloadpacket
        coll = _collective(func)
        if coll is not None:
            kind, wire = coll
            b = sum(_nbytes(t) for t in _tensors(args[wire]))
            _add(tot.collective_bytes, kind, b)
            _add(tot.collective_counts, kind, 1)
            self._charge_bytes(kind, b + sum(_nbytes(t) for t in
                                             _tensors(out)))
            return
        if func.namespace != "aten" or packet in FREE_OPS:
            return
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            tot.dot_flops += f
            ins = [t for t in args if isinstance(t, torch.Tensor)]
            _add(tot.dot_table, f"{packet.__name__} "
                 + "x".join(_shape(t) for t in ins), f)
        elif packet in ELEMENTWISE_FLOP_OPS:
            self._elementwise(packet, sum(t.numel() for t in _tensors(out)))
        elif packet in REDUCE_OPS and args and isinstance(args[0],
                                                          torch.Tensor):
            self._elementwise(packet, args[0].numel())
        upd = UPDATE_OPS.get(packet)
        if upd is not None and len(args) > upd[0]:
            i, reads = upd
            b = 2 * sum(_nbytes(t) for t in _tensors(args[i]))
            b += sum(_nbytes(t) for j in reads for t in _tensors(args[j]))
        else:
            b = (sum(_nbytes(t) for t in _tensors((args, kwargs)))
                 + sum(_nbytes(t) for t in _tensors(out)))
        self._charge_bytes(packet.__name__, b)

    def _elementwise(self, packet, n: int) -> None:
        self.totals.elementwise_flops += n
        _add(self.elementwise_table, packet.__name__, n)

    def _charge_bytes(self, op: str, b: float) -> None:
        self.totals.bytes_accessed += b
        _add(self.totals.bytes_table, op, b)

    # ------------------------------------------------------------ results
    def memory(self, outputs: Any = None) -> Dict[str, Optional[int]]:
        """``argument_bytes``, ``output_bytes`` (the distinct storages of
        ``outputs``), ``temp_bytes`` (the peak of the live bytes of the
        storages the step created) and ``generated_code_bytes`` (``None``:
        eager has no compiled program)."""
        seen, out_b = set(), 0
        for t in _tensors(outputs):
            st = t.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                out_b += st.nbytes()
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": out_b,
                "temp_bytes": self.peak_temp_bytes,
                "generated_code_bytes": None}


def analyze_step(fn: Callable, *args: Any) -> CostTotals:
    """The :class:`CostTotals` of ``fn(*args)`` run once under a
    :class:`CostCounter`: the counterpart of the reference's
    ``analyze_hlo(compiled.as_text())``."""
    with CostCounter() as c:
        c.arguments(*args)
        fn(*args)
    return c.totals
