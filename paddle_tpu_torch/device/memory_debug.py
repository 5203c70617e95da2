"""Memory accounting (the port of ``paddle_tpu/device/memory_debug.py``).

The reference asks XLA: a compiled program's argument, output and temp
bytes, which donated buffers its outputs alias, and the live device
arrays.  The port has no compiled program, so each tool asks torch what
the same question means for eager kernels: ``memory_analysis`` runs the
function once and reads the caching allocator's peak; ``donation_audit``
reports which argument storages the outputs share (an in-place function
"honors" a donation, a fresh result does not); ``live_arrays_report`` is
a census of the live tensors.
"""

from __future__ import annotations

import gc
from collections import Counter
from typing import Any, Callable, Dict, Sequence

import torch
from torch.utils import _pytree

__all__ = ["memory_analysis", "donation_audit", "live_arrays_report"]


def _leaves(x):
    return [t for t in _pytree.tree_leaves(x) if torch.is_tensor(t)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _storages(ts):
    return {t.untyped_storage().data_ptr() for t in ts
            if t.layout is torch.strided and t.numel()}


def memory_analysis(fn: Callable, *example_args,
                    donate_argnums: Sequence[int] = (),
                    static_argnums: Sequence[int] = ()) -> Dict[str, Any]:
    """Run ``fn(*example_args)`` once and report its bytes: arguments,
    outputs, ``alias_bytes`` (outputs sharing an argument's storage),
    ``temp_bytes`` (on the card: the allocator's peak during the call above
    what it held before, less the outputs; None on the CPU, which has no
    allocator statistics) and ``peak_estimate_bytes`` (their sum, aliases
    once).  ``code_bytes`` is None: no program is compiled."""
    args = list(example_args)
    arg_leaves = _leaves([a for i, a in enumerate(args)
                          if i not in set(static_argnums)])
    card = any(t.is_cuda for t in arg_leaves)
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    out = fn(*args)
    out_leaves = _leaves(out)
    arg_bytes = sum(_nbytes(t) for t in arg_leaves)
    out_bytes = sum(_nbytes(t) for t in out_leaves)
    shared = _storages(arg_leaves)
    alias = sum(_nbytes(t) for t in out_leaves
                if t.layout is torch.strided and
                t.untyped_storage().data_ptr() in shared)
    temp = None
    if card:
        torch.cuda.synchronize()
        temp = max(0, torch.cuda.max_memory_allocated() - base -
                   (out_bytes - alias))
    res = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
           "temp_bytes": temp, "alias_bytes": alias, "code_bytes": None}
    res["peak_estimate_bytes"] = arg_bytes + out_bytes + (temp or 0) - alias
    return res


def donation_audit(fn: Callable, *example_args,
                   donate_argnums: Sequence[int],
                   static_argnums: Sequence[int] = ()) -> Dict[str, Any]:
    """Run ``fn`` once and report, for each donated argument (a tensor or
    a pytree of them), whether every leaf's storage is shared by an output
    (``honored``) and the bytes of the leaves that are not."""
    out_storages = _storages(_leaves(fn(*example_args)))
    per_arg, wasted = [], 0
    for i in donate_argnums:
        leaves = _leaves(example_args[i])
        honored = [t.layout is torch.strided and
                   t.untyped_storage().data_ptr() in out_storages
                   for t in leaves]
        missed = sum(_nbytes(t) for t, h in zip(leaves, honored) if not h)
        wasted += missed
        per_arg.append({"argnum": i,
                        "bytes": sum(_nbytes(t) for t in leaves),
                        "honored": missed == 0, "leaves": len(leaves),
                        "honored_leaves": sum(honored)})
    return {"donated": per_arg, "unhonored_bytes": wasted,
            "honored_all": wasted == 0}


def live_arrays_report(top: int = 20) -> Dict[str, Any]:
    """The live tensors (dense, not meta) grouped by (device, dtype,
    shape), largest first; ``total_bytes`` counts each storage once."""
    groups: Counter = Counter()
    bytes_by: Counter = Counter()
    storages = {}
    for obj in gc.get_objects():
        if not issubclass(type(obj), torch.Tensor) or \
                obj.layout is not torch.strided or obj.is_meta:
            continue
        key = (str(obj.device), str(obj.dtype).replace("torch.", ""),
               tuple(obj.shape))
        groups[key] += 1
        bytes_by[key] += _nbytes(obj)
        st = obj.untyped_storage()
        storages[(str(obj.device), st.data_ptr())] = st.nbytes()
    rows = [{"device": k[0], "dtype": k[1], "shape": list(k[2]),
             "count": groups[k], "bytes": bytes_by[k]}
            for k, _ in bytes_by.most_common(top)]
    return {"total_bytes": sum(storages.values()),
            "total_arrays": sum(groups.values()), "top": rows}
