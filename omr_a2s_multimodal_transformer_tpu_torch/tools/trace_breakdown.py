"""Per-module device-time breakdown from a ``torch.profiler`` trace.

Port of ``tools/trace_breakdown.py``. JAX reads the xplane protobuf of a
``jax.profiler`` trace and groups the TPU's XLA op events by the module
path of their ``op_name`` metadata. The port reads the Chrome trace JSON
that ``torch.profiler`` writes (``export_chrome_trace``, or a
``tensorboard_trace_handler`` folder) and groups the GPU's kernel, memcpy
and memset events by module path, with JAX's ``group_key`` rules:

- a module path comes from the ``record_function`` ranges that
  ``ModuleRanges`` opens, named ``module::<path>``: forward hooks on every
  named module of a model, and around the decoder layer's parts that run no
  module of their own (the attention projections and products of
  ``self_attn`` and ``multihead_attn``, the banded self-attention, the
  flash cross-attention and the feed-forward ``ff``). The model code holds
  no range: the hooks and wrappers are the tool's and go when it exits;
- a kernel is attributed through its launch (the CUDA runtime call of the
  same correlation id) to the innermost range around the launch on the
  launching thread; a kernel launched in the backward, outside every range,
  through the autograd sequence number of the backward function around its
  launch to the forward op of that number, and to that op's range, as
  ``transpose(jvp(<path>))`` (JAX's ``[bwd]`` rows);
- the rest is one ``(unattributed)`` row, and the attributed share of the
  device time is printed; ``--roles`` adds the time by role (``ROLES``: the
  encoder's conv blocks 0-2 and the rest, the decoder layers' self- and
  cross-attention and feed-forward and the rest).

A trace that holds no GPU kernel raises, naming the file: an empty trace is
never read as a breakdown. ``--device cpu`` reads a CPU trace (the tests'):
the outermost CPU ops of each thread in place of kernels.

    python -m omr_a2s_multimodal_transformer_tpu_torch.tools.trace_breakdown TRACE [--depth 2] [--top 30]
"""

from __future__ import annotations

import argparse
import bisect
import glob
import gzip
import json
import os
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

RANGE = "module::"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BACKWARD = "autograd::engine::evaluate_function:"
UNATTRIBUTED = "(unattributed)"


def group_key(name: str, depth: int) -> str:
    parts = [p for p in name.split("/") if p and not p.startswith("jit(")]
    # strip transpose(...)/jvp(...) wrappers but remember backward-ness
    tag = ""
    if "transpose(" in name:
        tag = " [bwd]"
    parts = [p.replace("transpose(jvp(", "").replace("jvp(", "").rstrip(")")
             for p in parts]
    parts = [p for p in parts if p]
    return "/".join(parts[:depth]) + tag if parts else (name[:40] + tag)


# ------------------------------------------------------------------ the ranges


class ModuleRanges:
    """While entered: the module path of the code running on this thread
    (``current()``), and with ``profile`` a ``record_function`` range
    ``module::<path>`` around each named module's forward and each decoder
    layer's parts (module docstring). Paths are module names with '/' for
    '.'."""

    def __init__(self, model: torch.nn.Module, profile: bool = True):
        self.model, self.profile = model, profile
        self.stack: List[str] = []
        self._hooked, self._undo = [], []

    def current(self) -> str:
        return self.stack[-1] if self.stack else ""

    def span(self, path: str):
        ranges = self

        class _Span:
            def __enter__(self):
                ranges.stack.append(path)
                self.rf = torch.autograd.profiler.record_function(RANGE + path) if ranges.profile else None
                if self.rf is not None:
                    self.rf.__enter__()

            def __exit__(self, *exc):
                if self.rf is not None:
                    self.rf.__exit__(*exc)
                ranges.stack.pop()

        return _Span()

    def wrap(self, fn, path_of):
        """fn run inside the span ``path_of()`` names at its call."""
        def wrapped(*args, **kwargs):
            with self.span(path_of()):
                return fn(*args, **kwargs)
        return wrapped

    def _set(self, owner, name: str, value) -> None:
        had, old = name in vars(owner), vars(owner).get(name)
        setattr(owner, name, value)
        self._undo.append(lambda: setattr(owner, name, old) if had else delattr(owner, name))

    def __enter__(self):
        from omr_a2s_multimodal_transformer_tpu_torch.models import decoder as dec

        for name, m in self.model.named_modules():
            if not name:
                continue
            path = name.replace(".", "/")
            pre = m.register_forward_pre_hook(lambda _m, _a, _p=path: self._push(_p))
            post = m.register_forward_hook(lambda _m, _a, _o: self._pop(), always_call=True)
            self._undo += [pre.remove, post.remove]
            if isinstance(m, dec.MultiheadProj):
                for meth in ("project", "q_proj", "k_proj", "v_proj", "out"):
                    self._set(m, meth, self.wrap(getattr(m, meth), lambda _p=path: _p))
            if isinstance(m, dec.DecoderLayer):
                self._set(m, "_ff", self.wrap(m._ff, lambda _p=path: _p + "/ff"))
        inner = lambda part: (lambda: self.current() + "/" + part)  # noqa: E731 - a layer's part
        self._set(dec, "banded_causal_attention", self.wrap(dec.banded_causal_attention, inner("self_attn")))
        auto = dec.flash_attention_packed_auto
        self._set(dec, "flash_attention_packed_auto",
                  lambda *a, **k: self.wrap(auto(*a, **k), inner("multihead_attn")))
        return self

    def _push(self, path: str) -> None:
        span = self.span(path)
        span.__enter__()
        self._hooked.append(span)

    def _pop(self) -> None:
        self._hooked.pop().__exit__(None, None, None)

    def __exit__(self, *exc):
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()
        self.stack.clear()
        self._hooked.clear()


# ------------------------------------------------------------------ the trace


def trace_files(path: str) -> List[str]:
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "**", "*.json"), recursive=True)
                       + glob.glob(os.path.join(path, "**", "*.json.gz"), recursive=True))
        if not files:
            raise SystemExit(f"no .json trace under {path}")
        return files
    return [path]


def load_events(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


class _Intervals:
    """(start, end, value) intervals of one thread: the innermost around a time."""

    def __init__(self, rows):
        self.rows = sorted(rows, key=lambda r: (r[0], r[1]))
        self.starts = [r[0] for r in self.rows]

    def at(self, ts: float):
        i = bisect.bisect_right(self.starts, ts)
        while i > 0:
            i -= 1
            start, end, value = self.rows[i]
            if end >= ts:
                return value
        return None


def _by_thread(events) -> Dict:
    out = defaultdict(list)
    for e in events:
        out[(e.get("pid"), e.get("tid"))].append((e["ts"], e["ts"] + e.get("dur", 0), e))
    return out


def _outermost(rows) -> list:
    out, end = [], -1.0
    for start, stop, e in sorted(rows, key=lambda r: (r[0], -r[1])):
        if start >= end:
            out.append(e)
            end = stop
    return out


def attribute(events, device: str = "cuda", path: str = "trace") -> List[Tuple[str, float]]:
    """[(name, ms)] of each device event (``device`` 'cuda': kernels,
    memcpys and memsets; 'cpu': each thread's outermost CPU ops): the
    module path of its range, ``transpose(jvp(<path>))`` for one reached
    through the backward, or UNATTRIBUTED. Raises if a CUDA trace holds no
    kernel."""
    xs = [e for e in events if e.get("ph") == "X"]
    ranges = {k: _Intervals((s, t, e["name"][len(RANGE):]) for s, t, e in v)
              for k, v in _by_thread([e for e in xs if e.get("cat") == "user_annotation"
                                      and e["name"].startswith(RANGE)]).items()}
    cpu_ops = [e for e in xs if e.get("cat") == "cpu_op"]
    fwd_seq = {}
    for e in sorted(cpu_ops, key=lambda e: e["ts"]):
        seq = e.get("args", {}).get("Sequence number")
        if seq is not None and not e["name"].startswith(BACKWARD) and seq not in fwd_seq:
            fwd_seq[seq] = e
    backward = {k: _Intervals((s, t, e["args"].get("Sequence number")) for s, t, e in v)
                for k, v in _by_thread([e for e in cpu_ops if e["name"].startswith(BACKWARD)]).items()}

    def module_at(key, ts) -> Optional[str]:
        r = ranges.get(key)
        return r.at(ts) if r is not None else None

    def name_at(key, ts) -> str:
        p = module_at(key, ts)
        if p is not None:
            return p
        b = backward.get(key)
        seq = b.at(ts) if b is not None else None
        fwd = fwd_seq.get(seq)
        if fwd is not None:
            p = module_at((fwd.get("pid"), fwd.get("tid")), fwd["ts"])
            if p is not None:
                return f"transpose(jvp({p}))"
        return UNATTRIBUTED

    out = []
    if device == "cpu":
        for key, rows in _by_thread(cpu_ops).items():
            out += [(name_at(key, e["ts"]), e.get("dur", 0) / 1e3) for e in _outermost(rows)]
        return out
    kernels = [e for e in xs if e.get("cat") in DEVICE_CATS]
    if not any(e.get("cat") == "kernel" for e in kernels):
        raise RuntimeError(f"{path}: the trace holds no GPU kernel event (an empty trace is not a breakdown)")
    launches = {e["args"]["correlation"]: e for e in xs
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    for e in kernels:
        launch = launches.get(e.get("args", {}).get("correlation"))
        name = UNATTRIBUTED if launch is None else name_at((launch.get("pid"), launch.get("tid")), launch["ts"])
        out.append((name, e.get("dur", 0) / 1e3))
    return out


def breakdown(path: str, depth: int = 2, device: str = "cuda") -> dict:
    """{groups: {group_key: ms}, total_ms, attributed_ms, events} of every
    trace file under ``path``."""
    groups, total, attributed, n = defaultdict(float), 0.0, 0.0, 0
    for f in trace_files(path):
        for name, ms in attribute(load_events(f), device, f):
            key = UNATTRIBUTED if name == UNATTRIBUTED else group_key(name, depth)
            groups[key] += ms
            total += ms
            attributed += 0.0 if name == UNATTRIBUTED else ms
            n += 1
    return dict(groups=dict(groups), total_ms=total, attributed_ms=attributed, events=n)


def print_breakdown(b: dict, top: int = 30, min_ms: float = 0.0) -> None:
    total = b["total_ms"]
    print(f"# {b['events']} device events, {total:.1f} ms total (all steps in trace); attributed "
          f"{b['attributed_ms']:.1f} ms ({100 * b['attributed_ms'] / max(total, 1e-12):.1f}%)")
    for k, v in sorted(b["groups"].items(), key=lambda kv: -kv[1])[:top]:
        if v < min_ms:
            break
        print(f"{v:10.2f} ms  {100*v/total:5.1f}%  {k}")


# a model's modules by role (the encoder's first three conv blocks, the rest of the encoder, the decoder layers'
# self-attention, cross-attention and feed-forward, the rest of the decoder), from groups of ROLE_DEPTH parts
ROLE_DEPTH = 6
ROLES = (("encoder blocks 0-2", re.compile(r"(image_|audio_)?encoder/conv_blocks/[012](/|$)")),
         ("encoder, the rest", re.compile(r"(image_|audio_)?encoder(/|$)")),
         ("decoder self-attention", re.compile(r"decoder/transformer_decoder/layers/\d+/self_attn(/|$)")),
         ("decoder cross-attention", re.compile(r"decoder/transformer_decoder/layers/\d+/multihead_attn(/|$)")),
         ("decoder feed-forward", re.compile(r"decoder/transformer_decoder/layers/\d+/ff(/|$)")),
         ("decoder, the rest", re.compile(r"decoder(/|$)")))


def roles(groups: Dict[str, float]) -> Dict[str, float]:
    """{role (and role + ' [bwd]'): ms} of a breakdown's groups; any other
    module under 'other modules', UNATTRIBUTED as it is."""
    out: Dict[str, float] = defaultdict(float)
    for key, ms in groups.items():
        path, bwd = (key[:-len(" [bwd]")], " [bwd]") if key.endswith(" [bwd]") else (key, "")
        role = UNATTRIBUTED if key == UNATTRIBUTED else next(
            (name for name, pat in ROLES if pat.match(path)), "other modules") + bwd
        out[role] += ms
    return dict(out)


def print_roles(b: dict) -> None:
    total = b["total_ms"]
    print("# by role")
    for k, v in sorted(roles(b["groups"]).items(), key=lambda kv: -kv[1]):
        print(f"{v:10.2f} ms  {100*v/total:5.1f}%  {k}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace_dir", help="a Chrome trace .json(.gz), or a folder of them")
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--min_ms", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: GPU kernel events (default); cpu: a CPU trace's outermost ops")
    ap.add_argument("--roles", action="store_true",
                    help=f"also the time by role (ROLES; the groups at depth {ROLE_DEPTH})")
    args = ap.parse_args(argv)
    b = breakdown(args.trace_dir, args.depth, args.device)
    print_breakdown(b, args.top, args.min_ms)
    if args.roles:
        print_roles(breakdown(args.trace_dir, ROLE_DEPTH, args.device))
    return b


if __name__ == "__main__":
    main()
