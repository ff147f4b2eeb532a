"""Operation, byte and memory counts of one step, op by op: the port's
counterpart of the JAX package's ``roofline/hlo_cost.py``.

``analyze_step(fn, *args)`` runs ``fn(*args)`` under a
``TorchDispatchMode`` that sees every aten op the step runs (its
backward pass included), on ``meta`` tensors (shapes only: the dry run)
or on the card. It returns:

  * ``flops``: ``torch.utils.flop_counter``'s formula for each op (the
    matrix products, batched products and convolutions; 2 per
    multiply-add), the counts ``FlopCounterMode`` gives;
  * ``bytes``: operand plus result bytes of every op that reads or
    writes data. Views, aliases and bare allocations cost nothing. This
    is the UNFUSED eager traffic, each op reading its inputs from and
    writing its outputs to memory. It differs by design from the JAX
    package's count, the fusion-boundary bytes of XLA's compiled
    program: there is no parity on bytes;
  * ``peak_bytes``: the high-water mark of the live storages, the
    arguments' included (each storage once, however many views it has),
    which stands in for ``compiled.memory_analysis()``. Storages are
    keyed by their ``StorageImpl`` (``_cdata``), never by data pointer:
    every ``meta`` storage has pointer 0. What the allocator rounds up
    and what a library allocates past the dispatcher (cuBLAS's
    workspace) is not seen;
  * ``argument_bytes``: the arguments' storages, each once;
  * ``output_bytes``: the storages of what the step returns that are not
    the arguments', each once (a decode step's caches, written in place,
    are the arguments'; the slot it writes is not counted);
  * ``n_ops`` and ``by_op`` ({aten op: {'calls', 'flops', 'bytes'}}).

A DTensor argument or result counts as this rank's local tensor, so a
sharded step (``launch/steps.py``) is counted per chip: its work runs on
local tensors.

A Python loop runs, and is counted, on every pass, so the count is
loop-aware by itself (``hlo_cost`` multiplies while bodies by their trip
count), and ``torch.utils.checkpoint``'s recomputation is counted where
it runs, in the backward pass.

``sites=True`` adds ``by_site``: the FLOPs by phase ('forward',
'recompute': model code run again inside the backward pass,
'backward': autograd's derivative formulas) and by the two innermost
lines of ``repro_torch`` that issued them; ``needed_flops``: the FLOPs
of the ops whose results the step's outputs depend on, found by
walking the op log backwards from the outputs, as a compiler's
dead-code elimination would; and ``dead_by_site``, the rest by site. On
a train step under ``torch.utils.checkpoint`` the difference is
recomputed work that nothing reads: a checkpoint re-runs the whole
function, the ops after the last one whose result the backward pass
saves included, where XLA's rematerialization computes only what the
backward pass needs.
"""
from __future__ import annotations

import sys
from collections import defaultdict
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

_ROOT = "repro_torch"
_SELF = ("roofline",)


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of ``tree``, a DTensor as this rank's local tensor (a
    sharded step is counted per chip)."""
    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _writes(func) -> bool:
    """Whether the op writes into one of its arguments (``add_``,
    ``copy_``, ``index_put_``, an ``out=`` form)."""
    return any(a.alias_info is not None and a.alias_info.is_write
               for a in func._schema.arguments)


def _site() -> tuple[str, str]:
    """(phase, the two innermost ``repro_torch`` lines outside this
    package, the caller's after ``<``)."""
    f = sys._getframe(2)
    lines: list[str] = []
    while f is not None and len(lines) < 2:
        path = f.f_code.co_filename
        i = path.rfind(_ROOT + "/")
        if i >= 0:
            rel = path[i + len(_ROOT) + 1:]
            if not rel.startswith(_SELF):
                lines.append(f"{rel}:{f.f_lineno}")
        f = f.f_back
    site = " < ".join(lines)
    if torch._C._current_graph_task_id() == -1:
        return "forward", site
    return ("backward" if not site or site.startswith("launch/")
            else "recompute"), site


class _Counter(TorchDispatchMode):
    def __init__(self, args, sites: bool):
        super().__init__()
        self.sites = sites
        self.flops = 0
        self.bytes = 0
        self.n_ops = 0
        self.by_op: dict = defaultdict(lambda: {"calls": 0, "flops": 0,
                                                "bytes": 0})
        self.by_site: dict = defaultdict(int)
        self.log: list = []
        self.refs: dict = {}          # every storage seen (sites=True)
        self.args: set = set()
        self.arg_bytes = 0
        for t in _tensors(args):
            st = t.untyped_storage()
            if st._cdata not in self.args:
                self.args.add(st._cdata)
                self.arg_bytes += st.nbytes()
                if sites:
                    self.refs[st._cdata] = StorageWeakRef(st)
        self.live: dict = {}          # storage -> (weak ref, bytes)
        self.live_bytes = 0
        self.peak = self.arg_bytes

    def _sweep(self) -> None:
        dead = [k for k, (ref, _) in self.live.items() if ref.expired()]
        for k in dead:
            self.live_bytes -= self.live.pop(k)[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not outs:
            return out
        ins = _tensors((args, kwargs))
        in_keys = {t.untyped_storage()._cdata for t in ins}
        out_st = [t.untyped_storage() for t in outs]
        new = [st for st in out_st
               if st._cdata not in in_keys and st._cdata not in self.args
               and st._cdata not in self.live]
        writes = _writes(func)
        if not new and not writes:
            return out                # a view or an alias: no data moved
        packet = func._overloadpacket
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        name = str(packet)
        moved = 0
        if not name.startswith("aten.empty") and \
                not name.startswith("aten.new_empty"):
            moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if new:
            for st in new:
                n = st.nbytes()
                self.live[st._cdata] = (StorageWeakRef(st), n)
                self.live_bytes += n
            # live_bytes counts storages freed since the last sweep, so
            # it can only overstate: sweep when it would set a new peak
            if self.arg_bytes + self.live_bytes > self.peak:
                self._sweep()
                self.peak = max(self.peak, self.arg_bytes + self.live_bytes)
        self.n_ops += 1
        self.flops += flops
        self.bytes += moved
        rec = self.by_op[name]
        rec["calls"] += 1
        rec["flops"] += flops
        rec["bytes"] += moved
        if self.sites:
            site = None
            if flops:
                site = _site()
                self.by_site[site] += flops
            for st in out_st:
                self.refs.setdefault(st._cdata, StorageWeakRef(st))
            self.log.append((flops, site, in_keys,
                             {st._cdata for st in out_st}))
        return out


def _needed(log: list, roots: set) -> tuple[int, dict]:
    """FLOPs of the ops that ``roots`` (storage keys) depend on, walking
    ``log`` backwards, and the dead FLOPs by site."""
    need = set(roots)
    flops, dead = 0, defaultdict(int)
    for f, site, ins, outs in reversed(log):
        if outs & need:
            need |= ins
            flops += f
        elif f:
            dead[site] += f
    return flops, dict(dead)


def analyze_step(fn: Callable, *args, sites: bool = False) -> dict:
    """Run ``fn(*args)`` once and count it (module docstring). The
    result also holds ``out``, what ``fn`` returned."""
    mode = _Counter(args, sites)
    with mode:
        out = fn(*args)
    outs = {st._cdata: st.nbytes() for st in
            (t.untyped_storage() for t in _tensors(out))
            if st._cdata not in mode.args}
    rec: dict[str, Any] = {
        "flops": mode.flops, "bytes": mode.bytes, "peak_bytes": mode.peak,
        "argument_bytes": mode.arg_bytes,
        "output_bytes": sum(outs.values()), "n_ops": mode.n_ops,
        "by_op": dict(mode.by_op), "out": out}
    if sites:
        rec["by_site"] = dict(mode.by_site)
        roots = {t.untyped_storage()._cdata for t in _tensors(out)}
        rec["needed_flops"], rec["dead_by_site"] = _needed(mode.log, roots)
    return rec
