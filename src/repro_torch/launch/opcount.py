"""The op counter: FLOPs, bytes and peak memory of a program run on meta
tensors -- the port's counterpart of the JAX package's HLO walk
(launch/hlo_walk.py) and post-SPMD analysis (launch/hlo_analysis.py).

JAX plans a cell by compiling it and reading XLA's text; PyTorch runs
eagerly and has no program text to read.  So the port runs the program
itself, on meta tensors (shapes and dtypes, no storage, no arithmetic),
under a TorchDispatchMode that sees every aten op the card would run:

  * flops: the products and attention, by `torch.utils.flop_counter`'s
    registry, exactly as `FlopCounterMode` counts them (an op the
    registry lacks is first decomposed, as there);
  * bytes: each op's tensor operands plus its results, the walk's
    convention with no fusion; views and bare allocations move none;
  * peak: the bytes of live storages allocated during the run, each
    storage counted once however many views it has, freed when the
    storage dies (its last tensor, saved-for-backward ones included);
  * the hand-written kernels: a meta tensor takes the card's route
    through each kernel's autograd.Function, whose forward only shapes
    its outputs and reports the kernel's work (kernels/work.py) here;
    they are counted apart, by name, and added to the totals.

`roofline_terms` is hlo_analysis.py's, verbatim.  There are no
collectives on one card: the wire bytes are 0.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import backend

__all__ = ["OpCounter", "roofline_terms"]

aten = torch.ops.aten
# shape and stride queries: not ops of the program (FlopCounterMode's list)
_QUERIES = {
    aten.sym_is_contiguous.default, aten.is_contiguous.default,
    aten.is_contiguous.memory_format, aten.is_strides_like_format.default,
    aten.is_non_overlapping_and_dense.default, aten.size.default,
    aten.sym_size.default, aten.stride.default, aten.sym_stride.default,
    aten.storage_offset.default, aten.sym_storage_offset.default,
    aten.numel.default, aten.sym_numel.default, aten.dim.default,
    torch.ops.prim.layout.default,
}
# allocations that write nothing, and a view the schema does not mark
_NO_TRAFFIC = {aten.empty, aten.empty_strided, aten.empty_like,
               aten.new_empty, aten.new_empty_strided, aten._unsafe_view}
_DECOMPOSES: dict = {}     # op -> has a CompositeImplicitAutograd kernel


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of an op's arguments or results: flat, or one level of
    lists (the fast path), else through the pytree."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out = []
    for x in tree:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in tree_leaves(x)
                       if isinstance(t, torch.Tensor))
        elif isinstance(x, dict):
            out.extend(_tensors(list(x.values())))
    return out


def _decomposes(func) -> bool:
    found = _DECOMPOSES.get(func)
    if found is None:
        dk = torch._C.DispatchKey.CompositeImplicitAutograd
        found = _DECOMPOSES[func] = dk in func.py_kernels or \
            torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), dk)
    return found


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Mode(TorchDispatchMode):
    def __init__(self, counter: "OpCounter"):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return NotImplemented
        if func is not torch.ops.prim.device.default and _decomposes(func):
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        self.counter._op(func, args, kwargs, out)
        return out


class OpCounter:
    """Counts the program run inside `with OpCounter() as oc:`.  Call
    `oc.arguments(tree)` first with the program's inputs (their storages
    are the arguments, not allocations), and `oc.outputs(tree)` last.

    After the block: `flops` (the registry's products and attention),
    `bytes`, `ops` (aten ops run), `kernels` ({name: {"calls", "flops",
    "tf32_flops", "bytes"}}), `kernel_flops` and `kernel_bytes` (their
    sums), `peak_bytes` (the most bytes allocated during the run live at
    once) and `memory()`."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.kernels: dict[str, dict] = {}
        self.by_op: dict[str, list] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}
        self._args: dict[int, int] = {}
        self._outs: dict[int, int] = {}
        self._mode = _Mode(self)
        self._sink = backend.meta_sink(self._kernel)

    def __enter__(self) -> "OpCounter":
        self._sink.__enter__()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._sink.__exit__(*exc)
        return False

    # ---------------------------------------------------------------- #
    def arguments(self, tree) -> None:
        for t in _tensors(tree):
            self._args[_storage_key(t)] = t.untyped_storage().nbytes()

    def outputs(self, tree) -> None:
        for t in _tensors(tree):
            self._outs[_storage_key(t)] = t.untyped_storage().nbytes()

    @property
    def kernel_flops(self) -> float:
        return sum(k["flops"] + k["tf32_flops"] for k in self.kernels.values())

    @property
    def kernel_bytes(self) -> float:
        return sum(k["bytes"] for k in self.kernels.values())

    def memory(self) -> dict:
        """The JAX dry-run's memory keys: arguments, outputs, the outputs
        that are arguments (written in place: donation), temp -- the
        traced peak above the arguments, less the new outputs live at the
        end -- and total = argument + temp + output - alias, the traced
        peak."""
        argument = sum(self._args.values())
        output = sum(self._outs.values())
        alias = sum(n for k, n in self._outs.items() if k in self._args)
        new_out = sum(n for k, n in self._outs.items() if k in self._live)
        mem = {"argument_bytes": argument, "output_bytes": output,
               "temp_bytes": self.peak_bytes - new_out,
               "alias_bytes": alias}
        mem["total_bytes"] = (argument + mem["temp_bytes"] + output - alias)
        return mem

    # ---------------------------------------------------------------- #
    def _kernel(self, name, *, flops, tf32_flops, nbytes) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "tf32_flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["tf32_flops"] += tf32_flops
        k["bytes"] += nbytes

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _op(self, func, args, kwargs, out) -> None:
        self.ops += 1
        packet = func._overloadpacket
        flops = 0.0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += flops
        outs = _tensors(out)
        moved = 0
        if not func.is_view and packet not in _NO_TRAFFIC:
            ins = _tensors(args) + _tensors(list(kwargs.values()))
            moved = sum(t.nbytes for t in ins) + sum(t.nbytes for t in outs)
            self.bytes += moved
        rec = self.by_op.setdefault(str(packet), [0, 0.0, 0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += moved
        if func.is_view:
            return
        if not outs:
            return
        seen = {_storage_key(t) for t in _tensors(args)
                + _tensors(list(kwargs.values()))}
        for t in outs:
            storage = t.untyped_storage()
            key = storage._cdata
            if key in seen or key in self._live or key in self._args:
                continue
            seen.add(key)
            self._live[key] = storage.nbytes()
            self.live_bytes += storage.nbytes()
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(storage, self._free, key)


def roofline_terms(*, flops: float, bytes_accessed: float,
                   wire_bytes: float, model_flops_per_device: float,
                   peak_flops: float, hbm_bw: float, ici_bw: float) -> dict:
    """The three roofline terms (seconds, per device) + derived metrics."""
    compute_t = flops / peak_flops
    memory_t = bytes_accessed / hbm_bw
    collective_t = wire_bytes / ici_bw
    terms = {"compute_s": compute_t, "memory_s": memory_t,
             "collective_s": collective_t}
    dominant = max(terms, key=terms.get)
    step_t = max(compute_t, memory_t, collective_t)
    useful_t = model_flops_per_device / peak_flops
    return {
        **terms,
        "dominant": dominant,
        "step_time_s": step_t,
        "model_flops_per_device": model_flops_per_device,
        "useful_flop_ratio": (model_flops_per_device / flops
                              if flops else 0.0),
        "roofline_fraction": useful_t / step_t if step_t else 0.0,
    }
