"""Memory-traffic attribution of a PyTorch step by module path.

Port of ``tools/hlo_bytes.py``, which sums the result and operand bytes of
every instruction of XLA's optimized HLO text and groups them by the
``op_name`` metadata's module path. The port has no HLO: what stands in for
it is the step itself, run once under a ``TorchDispatchMode`` that sums, for
each ATen op it dispatches, the bytes of its tensor operands and results
(the element sizes of ``_DTYPE_BYTES``, by JAX's dtype names). Ops that
only make a view (``OpOverload.is_view``) move no bytes and are skipped, as
HLO's bitcasts are. The kernels K1 and K2 run outside ATen (``ctypes``), so
their wrappers count their own operands and results while counting.

Each op is grouped by the module path of ``trace_breakdown.ModuleRanges``
(its forward hooks and the decoder layer's parts); an op of the backward by
the forward op of its autograd node's sequence number, as
``transpose(jvp(<path>))``; then ``_clean_op_name`` keeps the last five
parts, as JAX's does. Ops outside every module (the loss, Adam) group under
their op name. A ranking tool, not an exact model: an op that the caching
allocator or a fused kernel keeps on chip is counted as read and written,
as HLO's non-fused neighbours are.

    rows = instruction_bytes(step_fn, model)   # [(group, bytes, op)]
    print_top(rows, top=30)
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from omr_a2s_multimodal_transformer_tpu_torch.tools.trace_breakdown import ModuleRanges

_DTYPE_BYTES = {
    "pred": 1, "s2": 0.25, "u2": 0.25, "s4": 0.5, "u4": 0.5,
    "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
    "f32": 4, "s32": 4, "u32": 4,
    "f64": 8, "s64": 8, "u64": 8, "c64": 8, "c128": 16,
}

# torch dtypes by JAX's names
_JAX_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8", torch.float8_e4m3fn: "f8e4m3fn",
    torch.float8_e5m2: "f8e5m2", torch.bfloat16: "bf16", torch.float16: "f16", torch.int16: "s16",
    torch.float32: "f32", torch.int32: "s32", torch.float64: "f64", torch.int64: "s64",
    torch.complex64: "c64", torch.complex128: "c128",
}


def tensor_bytes(t: torch.Tensor) -> float:
    return t.numel() * _DTYPE_BYTES.get(_JAX_NAMES.get(t.dtype, ""), 0.0)


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _clean_op_name(name: str) -> str:
    # transpose(jvp(decoder/transformer_decoder/layers/0/ff)) -> keep the
    # informative tail; strip jit()/named wrappers
    parts = [p for p in name.split("/") if not p.startswith("jit(")]
    return "/".join(parts[-5:]) if parts else name


class ByteCounter:
    """While entered, every ATen op (and every K1/K2 launch) adds a row
    (group, bytes, op) to ``rows``; the groups as the module docstring says."""

    def __init__(self, model: torch.nn.Module):
        self.ranges = ModuleRanges(model, profile=False)
        self.rows: List[Tuple[str, float, str]] = []
        self.seq_path: Dict[int, str] = {}
        counter = self

        class _Fwd(TorchFunctionMode):  # the forward: each autograd node's sequence number -> its module path
            def __torch_function__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                path = counter.ranges.current()
                if path:
                    for t in _tensors(out):
                        if t.grad_fn is not None:
                            counter.seq_path.setdefault(t.grad_fn._sequence_nr(), path)
                return out

        class _Ops(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if not func.is_view:
                    counter.add(str(func.overloadpacket.__name__), _tensors(args) + _tensors(kwargs) + _tensors(out))
                return out

        self._modes = (_Fwd(), _Ops())

    def group(self, op: str) -> str:
        path = self.ranges.current()
        if path:
            return _clean_op_name(path)
        node = torch._C._current_autograd_node()
        if node is not None and node._sequence_nr() in self.seq_path:
            return _clean_op_name(f"transpose(jvp({self.seq_path[node._sequence_nr()]}))")
        return op

    def add(self, op: str, tensors) -> None:
        self.rows.append((self.group(op), float(sum(tensor_bytes(t) for t in tensors)), op))

    def _counted(self, fn, op: str):
        def counted(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.add(op, _tensors(args) + _tensors(kwargs) + _tensors(out))
            return out
        counted.launches = fn.launches
        return counted

    def __enter__(self):
        from omr_a2s_multimodal_transformer_tpu_torch.ops import flash_packed as fp

        self._saved = fp.flash_fwd_cuda, fp.flash_bwd_cuda
        fp.flash_fwd_cuda = self._counted(fp.flash_fwd_cuda, "K1 flash fwd")
        fp.flash_bwd_cuda = self._counted(fp.flash_bwd_cuda, "K2 flash bwd")
        self.ranges.__enter__()
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        from omr_a2s_multimodal_transformer_tpu_torch.ops import flash_packed as fp

        for m in reversed(self._modes):
            m.__exit__(*exc)
        self.ranges.__exit__(*exc)
        for real, wrapper in zip(self._saved, (fp.flash_fwd_cuda, fp.flash_bwd_cuda)):
            real.launches = wrapper.launches  # the launches made meanwhile, counted on the module's name
        fp.flash_fwd_cuda, fp.flash_bwd_cuda = self._saved


def instruction_bytes(step: Callable[[], object], model: torch.nn.Module) -> List[Tuple[str, float, str]]:
    """[(group, bytes, op)] of each op of one call of ``step()`` (which runs
    ``model``), in order."""
    with ByteCounter(model) as counter:
        step()
    return counter.rows


def grouped(rows: List[Tuple[str, float, str]]) -> Dict[str, float]:
    g: Dict[str, float] = defaultdict(float)
    for name, b, _ in rows:
        g[name] += b
    return dict(g)


def print_top(rows: List[Tuple[str, float, str]], top: int = 30) -> None:
    ranked = sorted(grouped(rows).items(), key=lambda kv: -kv[1])
    total = sum(b for _, b in ranked)
    print(f"# op traffic attribution: {total/1e9:.1f} GB summed over "
          f"{len(ranked)} op groups (top {top})")
    cum = 0.0
    for name, b in ranked[:top]:
        cum += b
        print(f"{b/1e9:8.2f} GB  {100*b/total:5.1f}%  (cum {100*cum/total:5.1f}%)  {name}")
