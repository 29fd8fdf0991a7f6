"""Counts the work of a PyTorch program from its dispatch trace: the port's
counterpart of ``repro/roofline/hlo_parse.py``.

The reference reads a compiled program's cost from XLA (``cost_analysis``)
and its collective bytes from the HLO text. Eager PyTorch has no compiled
program: what the card reads, writes and computes is the sequence of
operators that a step dispatches. ``Counter`` is a ``TorchDispatchMode``
that sees each of them and keeps, over a window:

- **FLOPs by dtype class** (``"bf16"`` for bf16/fp16, ``"fp32"``,
  ``"int8"``), from ``torch.utils.flop_counter``'s formulas for the matrix
  products (``mm``, ``addmm``, ``bmm``, ``baddbmm``, the SDPA kernels and
  their backwards; ``mv``, ``addmv`` and ``dot`` at 2 a multiply-add),
  the class taken from the product's operands.
  Elementwise operators and reductions count no FLOPs, as in the
  reference's model FLOPs; their cost is in the bytes.
- **Bytes read and written**: each tensor an operator takes is read once
  and each tensor it returns written once, from the schema's alias
  information: a result that aliases an input without writing it (a
  view: ``view``, ``t``, ``detach``, ...) counts 0; an argument written
  in place (``add_``, ``copy_``) is read (but where it is overwritten)
  and written once, an ``out=`` argument written; an allocation
  (``empty*``) writes nothing. Two kinds of operator touch only some
  rows of a tensor, and count those, as the data needs them: a gather
  (``index``, ``index_select``, ``gather``, ``embedding``, ``take``) reads
  the rows it returns, not its whole table, and an in-place scatter
  (``index_put_``, ``index_copy_``, ``index_add_``, ``scatter_*``) writes
  its source's rows, not its whole destination.
- **Live bytes and their peak**, by storage: a storage counts once
  however many views read it, from the first time it is seen (made in the
  window, or passed to ``track``) to its release. On the meta device every
  ``data_ptr()`` is 0, so storages are keyed by their Python objects, which
  PyTorch keeps one per storage while the storage lives, and a weak
  reference's callback takes a storage off when it is freed.
- **Operator counts** by name.

Two hooks report what the trace cannot see:

- ``kernel(name, ...)``: the region of one hand-written kernel call. Each
  kernel wrapper opens it on every route (the CUDA launch, the plain
  version on the CPU, the meta route that allocates the outputs and
  computes nothing). Inside it the kernel is counted by its own formula
  (the one of its bound in ``PERF.md``) and the operators of its plain
  version are not counted, so a CPU probe, a meta trace and a card run of
  the same step count the same work. Allocations inside still count as
  live; the peak is read where the route says so (``peak_here``, once the
  kernel's outputs and workspaces are allocated) and at the region's end,
  where the plain version has freed its temporaries.
- ``collective(kind, ...)``: ``sharding/collectives.py`` reports each
  collective with the reference's per-device conventions
  (``hlo_parse.py``): an all-reduce moves 2x its bytes, an all-gather its
  result's, a collective-permute its operand's. ``per_device`` is what one
  shard's program would move, as the reference parses it from the
  per-device HLO; ``collective_total`` sums it over the shards that take
  part.

``assume(text)`` records an assumption behind the numbers (for example a
worst case taken where meta tensors hold no data). Nothing here is active
unless a ``Counter`` is entered: outside one, ``kernel`` and
``collective`` cost what ``active()`` does to find none, a thread-local
lookup and a walk over the thread's dispatch-mode stack (empty outside
a mode, so a few attribute reads a wrapper call).

A counter is active where its dispatch mode is: in the thread that
entered it, and in autograd's threads while they run that thread's
backward (they inherit its modes). The bodies of
``sharding.collectives.spmd`` run in threads of their own and are not
counted, but their collectives are, since the rendezvous that computes
them reports to the caller's counter (``attached``).
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from collections import Counter as _Tally
from typing import Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten

# link bytes per device of each collective, as a multiple of its bytes
# (the reference's ``_COLLECTIVES``: ring algorithms)
COLLECTIVES = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

FLOP_CLASSES = ("bf16", "fp32", "int8")

# operators that allocate and write nothing; operators that overwrite
# their first argument without reading it
_ALLOCATE = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "empty_permuted"}
_OVERWRITE = {"copy_", "fill_", "zero_", "normal_", "uniform_", "random_"}
# operators that read only the rows they return from their first argument,
# and operators that write in place only the rows of their source
_GATHER = {"index", "index_select", "gather", "embedding", "take"}
_SCATTER = {"index_put_", "index_copy_", "index_add_", "scatter_",
            "scatter_add_", "scatter_reduce_", "index_reduce_", "put_",
            "_index_put_impl_"}

_LOCAL = threading.local()     # .lent: counters lent to this thread


def flop_class(dtype: torch.dtype) -> str:
    """The peak a product of ``dtype`` operands runs at on the card."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype in (torch.int8, torch.uint8):
        return "int8"
    return "fp32"


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def active() -> Optional["Counter"]:
    """This thread's counter: one lent to it (``attached``), else the
    innermost ``Counter`` on its dispatch-mode stack, or None."""
    lent = getattr(_LOCAL, "lent", None)
    if lent:
        return lent[-1]
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, Counter):
            return mode
    return None


@contextlib.contextmanager
def attached(counter: Optional["Counter"]):
    """``counter`` (entered in another thread) is this thread's active one
    while the block runs, for the hooks (``collective``): its dispatch mode
    is not entered here, so this thread's operators are not counted. The
    caller makes sure no other thread uses the counter meanwhile."""
    if counter is None:
        yield
        return
    if not hasattr(_LOCAL, "lent"):
        _LOCAL.lent = []
    _LOCAL.lent.append(counter)
    try:
        yield
    finally:
        _LOCAL.lent.remove(counter)


def _mv_flops(a, b, *rest, out_val=None, **kw) -> int:
    return 2 * a.numel()


def _addmv_flops(bias, a, b, *rest, out_val=None, **kw) -> int:
    return 2 * a.numel()


def _dot_flops(a, b, *rest, out_val=None, **kw) -> int:
    return 2 * a.numel()


def _flop_registry() -> dict:
    """``torch.utils.flop_counter``'s formulas, and the matrix-vector and
    vector products' (2 FLOPs a multiply-add), which it has none for."""
    from torch.utils.flop_counter import flop_registry
    aten = torch.ops.aten
    return {**flop_registry, aten.mv: _mv_flops, aten.addmv: _addmv_flops,
            aten.dot: _dot_flops, aten.vdot: _dot_flops}


class Counter(TorchDispatchMode):
    """The dispatch-trace counter (the module docstring). Use as a context
    manager; read its fields, or ``summary()``, afterwards."""

    def __init__(self):
        super().__init__()
        self.flops: Dict[str, float] = {c: 0.0 for c in FLOP_CLASSES}
        self.bytes_read = 0
        self.bytes_written = 0
        self.kernel_bytes = 0.0
        self.ops: _Tally = _Tally()
        self.kernels: Dict[str, dict] = {}
        self.collective_bytes: Dict[str, float] = {}
        self.collective_total: Dict[str, float] = {}
        self.collective_ops: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.assumptions: List[str] = []
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, tuple] = {}
        self._region = 0
        self._registry = _flop_registry()

    # -- live bytes -------------------------------------------------------
    def _see(self, t) -> None:
        if not isinstance(t, torch.Tensor) or t.is_sparse:
            return
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = id(st)
        if key in self._storages:
            return
        nbytes = st.nbytes()
        storages = self._storages

        def gone(_ref, key=key, nbytes=nbytes, counter=weakref.ref(self)):
            c = counter()
            if c is not None and storages.pop(key, None) is not None:
                c.live -= nbytes

        self._storages[key] = (weakref.ref(st, gone), nbytes)
        self.live += nbytes
        if not self._region:
            self.peak = max(self.peak, self.live)

    def track(self, *trees) -> int:
        """Counts the tensors of ``trees`` (made before the window: the
        state a step takes) as live from now; returns the bytes added."""
        before = self.live
        for tree in trees:
            for t in tree_flatten(tree)[0]:
                self._see(t)
        return self.live - before

    # -- the trace --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        for t in outs:
            self._see(t)
        if self._region:
            return out
        name = func.overloadpacket.__name__
        self.ops[name] += 1
        packet = func.overloadpacket
        if packet in self._registry:
            mats = [a for a in tree_flatten((args, kwargs))[0]
                    if isinstance(a, torch.Tensor) and a.dim() >= 1]
            mats.sort(key=lambda a: -a.dim())
            cls = flop_class(mats[0].dtype if mats else torch.float32)
            self.flops[cls] += float(self._registry[packet](
                *args, **kwargs, out_val=out))
        if name in _ALLOCATE:
            return out
        read, written = self._bytes(func, args, kwargs, outs)
        self.bytes_read += read
        self.bytes_written += written
        return out

    def _bytes(self, func, args, kwargs, outs):
        schema = func._schema
        rets = schema.returns
        # a result that aliases an input without writing it: a view
        if rets and all(r.alias_info is not None and not r.alias_info.is_write
                        for r in rets):
            return 0, 0
        name = func.overloadpacket.__name__
        read = written = 0
        for i, a in enumerate(schema.arguments):
            val = (kwargs.get(a.name) if a.kwarg_only or i >= len(args)
                   else args[i])
            ts = [t for t in tree_flatten(val)[0]
                  if isinstance(t, torch.Tensor)]
            if not ts:
                continue
            if a.is_out:
                written += sum(tensor_bytes(t) for t in ts)
            elif a.alias_info is not None and a.alias_info.is_write:
                # written in place: a scatter writes the rows it is given
                # (counted with its source), anything else the whole tensor
                if name not in _SCATTER:
                    written += sum(tensor_bytes(t) for t in ts)
                    if name not in _OVERWRITE:
                        read += sum(tensor_bytes(t) for t in ts)
            elif name in _GATHER and i == 0:
                # a gather reads the rows it returns, not its whole table
                read += sum(tensor_bytes(t) for t in outs)
            else:
                read += sum(tensor_bytes(t) for t in ts)
                if name in _SCATTER and ts[0].is_floating_point():
                    written += sum(tensor_bytes(t) for t in ts)
        # results that alias an argument were counted with it
        fresh = [t for t, r in zip(outs, rets) if r.alias_info is None]
        written += sum(tensor_bytes(t) for t in fresh)
        return read, written

    # -- hooks ------------------------------------------------------------
    def note_op(self, name: str, read: int, written: int) -> None:
        """An operator that the trace cannot see (its meta stand-in ran
        other operators), counted by its own bytes."""
        self.ops[name] += 1
        self.bytes_read += int(read)
        self.bytes_written += int(written)

    def assume(self, text: str) -> None:
        if text not in self.assumptions:
            self.assumptions.append(text)

    @property
    def bytes(self) -> float:
        """Bytes read and written by the operators and the kernels."""
        return self.bytes_read + self.bytes_written + self.kernel_bytes

    def summary(self) -> dict:
        """The window's totals as plain numbers (a dry-run record's)."""
        return {
            "flops": dict(self.flops),
            "flops_total": sum(self.flops.values()),
            "bytes": self.bytes, "bytes_read": self.bytes_read,
            "bytes_written": self.bytes_written,
            "kernel_bytes": self.kernel_bytes,
            "peak_bytes": self.peak,
            "ops": sum(self.ops.values()),
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
            "collective_bytes_per_device": dict(
                self.collective_bytes,
                total=float(sum(self.collective_bytes.values()))),
            "collective_bytes_total": dict(
                self.collective_total,
                total=float(sum(self.collective_total.values()))),
            "collective_op_counts": dict(self.collective_ops),
            "assumptions": list(self.assumptions),
        }


@contextlib.contextmanager
def kernel(name: str, work: Callable[[], tuple]):
    """The region of one call of the hand-written kernel ``name``. ``work()``
    gives ``(flops, flops_class, bytes)`` by the kernel's own formula; it is
    called only when a counter is active (it may read the data, which on the
    card waits for the device)."""
    c = active()
    if c is None:
        yield
        return
    c._region += 1
    try:
        yield
        flops, cls, nbytes = work()      # its reads are not counted either
    finally:
        c._region -= 1
        if not c._region:
            c.peak = max(c.peak, c.live)
    k = c.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                    "bytes": 0.0})
    k["launches"] += 1
    k["flops"] += float(flops)
    k["bytes"] += float(nbytes)
    c.flops[cls] += float(flops)
    c.kernel_bytes += float(nbytes)


def peak_here() -> None:
    """Inside a kernel region: the live bytes now (the kernel's outputs and
    workspaces, all held during its launch) count toward the peak."""
    c = active()
    if c is not None:
        c.peak = max(c.peak, c.live)


def assume(text: str) -> None:
    """Records an assumption in the active counter, if any."""
    c = active()
    if c is not None:
        c.assume(text)


def note_op(name: str, read: int, written: int) -> None:
    c = active()
    if c is not None:
        c.note_op(name, read, written)


def collective(kind: str, nbytes: int, participants: int) -> None:
    """One collective of ``kind`` (an HLO name of ``COLLECTIVES``) whose
    per-device operand (all-reduce, collective-permute) or result
    (all-gather) is ``nbytes``, over ``participants`` shards."""
    c = active()
    if c is None or participants <= 0:
        return
    per_device = COLLECTIVES[kind] * nbytes
    c.collective_bytes[kind] = c.collective_bytes.get(kind, 0.0) + per_device
    c.collective_total[kind] = (c.collective_total.get(kind, 0.0)
                                + per_device * participants)
    c.collective_ops[kind] += 1


def count_collective_ops(counter: Counter) -> Dict[str, int]:
    """Calls of each collective kind in the window (the reference's
    ``count_collective_ops`` over the HLO text)."""
    return dict(counter.collective_ops)
