"""Captured CUDA graphs: the port's counterpart of the JAX package's jit.

The JAX package compiles each per-frame program (the frame builds, the
LiDAR feature extraction, the tracking step, local BA) into one XLA
program per shape bucket and runs it with one dispatch. On the card the
counterpart is a CUDA graph: `graphed(fn, static_argnames=...)` captures
`fn` once per cache key and replays it with one launch. The graph holds the
very kernels the eager function launches, in the same order, so a replay
gives the eager function's bits.

* Cache key: the static arguments (`static_argnames`, by value: the JAX
  function's static arguments), the nesting of the other arguments (tuples,
  NamedTuples, lists, dicts), their non-tensor values, every tensor's
  shape, strides and dtype, and whether cuBLAS may use TF32 (a graph keeps
  the math mode of its capture). A value that is neither a tensor nor hashable (a
  numpy array) raises `TypeError`: convert it to a tensor first.
* `max_entries`: a function whose shapes change with every call of its
  caller keeps only its newest captures. The loop correction's programs
  (the essential graph, global BA, the LiDAR pose graph) get new shapes at
  every loop closure; with `max_entries=1` the capture of a new key drops
  the previous one and empties the allocator's cache
  (`torch.cuda.empty_cache`), which gives the dropped graphs' memory pools
  back to the device: no later capture reuses a private pool, and a run
  that never emptied the cache grew its reserved memory by GBs a loop
  correction until it ran out of the card's 80 GB (`run_kitti --mode
  fusion --loop --pipelined --async-mapping` over `kitti_synth`, frame
  ~890; PERF.md section 6). A pool whose replay was in flight at the drop is
  given back at the next one. Device memory then holds one capture per program,
  however many loops a run closes: over `eval/longrun.py`'s 1,000 frames
  the essential graph's step was captured 8 times (a loop and seven
  vetoed corrections, ~480-540 keyframes) and `memory_reserved` after
  `empty_cache` ended 16 MB below its reading after the first loop
  (NVIDIA H100 80GB HBM3, 700 W; `chip_smoke.py` phase 19).
* First call of a key: the inputs are copied into static buffers of their
  own strides (the layout of a tensor can choose the kernel that reads it,
  and with it the bits: a solver's column-major result), `fn` runs
  once eagerly on a side stream (kernels built at first use and the
  kernels' one-time `cudaFuncSetAttribute` calls happen outside the
  capture; K3 takes a counter of the graph's own inside it, `optim/
  assembly.py`), then it is captured on that
  stream and replayed. A capture that fails raises; nothing falls back to
  the eager function.
* Every call: inputs are copied into the static buffers, the graph is
  replayed on the caller's current stream, and the caller gets fresh
  copies of the outputs (a later replay never overwrites them).
* Counts: a kernel wrapper counts its launches through `count_launch`;
  inside a capture the launch is noted for the graph, and each replay adds
  the graph's launches to the wrappers' counts. `utils.graph_captures` and
  `utils.graph_replays` count captures and replays; a graphed function's
  `.captures` counts its own (evicted ones too).
* CPU: when no argument lies on a CUDA device (the caller asked for the
  CPU) the eager function runs. Inside `disable_graphs()` (the counterpart
  of `jax.disable_jit()`) every graphed function runs eagerly, in every
  thread; a call made while its thread captures or warms up another graph
  runs eagerly inside it.

Each thread captures on its own side stream with
`capture_error_mode="thread_local"`, and one lock orders the captures of
all threads, so the asynchronous mapping worker can capture local BA while
the tracking thread replays its graphs. `enable_persistent_cache` (the XLA
compile cache) has no counterpart: a CUDA graph does not outlive its
process.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import sys
import threading
from typing import Callable, Iterable, NamedTuple, Optional

import torch

_lock = threading.RLock()  # counters, the eager switch, the entry tables
_capture_lock = threading.Lock()  # one capture at a time, process-wide
_local = threading.local()  # per thread: capture streams, launch tally, busy flag
_eager_depth = 0


@contextlib.contextmanager
def disable_graphs():
    """Run every graphed function eagerly inside the block, in every thread
    (the counterpart of `jax.disable_jit()`): the same system then runs op
    by op, for comparison with its graphs."""
    global _eager_depth
    with _lock:
        _eager_depth += 1
    try:
        yield
    finally:
        with _lock:
            _eager_depth -= 1


def _bump(module: str, counter: str, n: int) -> None:
    mod = sys.modules[module]
    with _lock:
        setattr(mod, counter, getattr(mod, counter) + n)


def count_launch(module: str, counter: str) -> None:
    """Count one launch of a kernel in `module.counter` (a module-level
    int). While this thread captures a graph the launch only runs at the
    graph's replays, so it is noted for the graph, whose replays add it."""
    tally = getattr(_local, "tally", None)
    if tally is not None:
        tally[(module, counter)] = tally.get((module, counter), 0) + 1
    else:
        _bump(module, counter, 1)


# ----------------------------------------------------------------------
# Argument trees: tensors are the graph's inputs, everything else is key.
# ----------------------------------------------------------------------

_TENSOR = object()
_CONST = object()


def _flatten(x, leaves: list):
    """Append the tensors of a nest of tuples / NamedTuples / lists / dicts
    to `leaves`; return a hashable spec of the nest and its other values."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return _TENSOR
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, dict):
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in x.items()))
    try:
        hash(x)
    except TypeError:
        raise TypeError(f"a graphed function takes tensors and hashable values, not "
                        f"{type(x).__name__}: pass it as a tensor") from None
    return (_CONST, x)


def _unflatten(spec, leaves: Iterable):
    it = iter(leaves)

    def build(s):
        if s is _TENSOR:
            return next(it)
        kind, body = s
        if kind is _CONST:
            return body
        if kind is dict:
            return {k: build(v) for k, v in body}
        vals = [build(v) for v in body]
        if kind is list:
            return vals
        return kind(*vals) if hasattr(kind, "_fields") else kind(vals)

    return build(spec)


class _Entry(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: list  # static input buffers
    outputs: list  # static output tensors (the graph's pool)
    out_spec: object
    launches: dict  # (module, counter) -> launches per replay
    lock: threading.Lock  # orders copy-in, replay and copy-out of callers


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    streams = getattr(_local, "streams", None)
    if streams is None:
        streams = _local.streams = {}
    s = streams.get(device)
    if s is None:
        s = streams[device] = torch.cuda.Stream(device)
    return s


class Graphed:
    """`fn` behind the graph cache (see the module docstring). Call it as
    `fn`; `.eager` is `fn` itself."""

    def __init__(self, fn: Callable, static_argnames=(), max_entries: Optional[int] = None):
        self.eager = fn
        self.static_argnames = tuple(static_argnames)
        self.max_entries = max_entries
        self._sig = inspect.signature(fn)
        self._entries: dict = {}
        self.captures = 0
        functools.update_wrapper(self, fn)

    def _split(self, args, kwargs):
        bound = self._sig.bind(*args, **kwargs)
        bound.apply_defaults()
        statics, dynamic = [], {}
        for name, value in bound.arguments.items():
            if name in self.static_argnames:
                if _leaves(value):
                    raise TypeError(f"static argument {name!r} holds a tensor")
                statics.append((name, value))
            else:
                dynamic[name] = value
        leaves: list = []
        spec = _flatten(dynamic, leaves)
        return tuple(statics), spec, leaves

    def key(self, *args, **kwargs):
        """The cache key of a call (computable for tensors on any device)."""
        return _key(*self._split(args, kwargs))

    def num_entries(self) -> int:
        return len(self._entries)

    def __call__(self, *args, **kwargs):
        statics, spec, leaves = self._split(args, kwargs)
        devices = {t.device for t in leaves}
        if (not any(d.type == "cuda" for d in devices) or _eager_depth > 0
                or getattr(_local, "busy", False)):
            return self.eager(*args, **kwargs)
        if len(devices) != 1:
            raise ValueError(f"{self.__name__}: a graphed call takes tensors on one CUDA "
                             f"device, got {sorted(map(str, devices))}")
        device = devices.pop()
        key = _key(statics, spec, leaves)
        entry = self._entries.get(key)
        if entry is None:
            entry = self._capture(key, statics, spec, leaves, device)
        return self._replay(entry, leaves)

    def _run(self, statics, spec, leaves):
        dynamic = _unflatten(spec, leaves)
        return self.eager(**dynamic, **dict(statics))

    def _capture(self, key, statics, spec, leaves, device) -> _Entry:
        with _capture_lock:
            entry = self._entries.get(key)
            if entry is not None:  # another thread captured it meanwhile
                return entry
            if self.max_entries is not None and len(self._entries) >= max(self.max_entries, 1):
                # Oldest first, before the new pool is taken; a replay in
                # flight keeps its entry alive until it returns. The dropped
                # pools go back to the device (see the module docstring).
                with _lock:
                    while len(self._entries) >= max(self.max_entries, 1):
                        del self._entries[next(iter(self._entries))]
                with torch.cuda.device(device):
                    torch.cuda.empty_cache()
            with torch.cuda.device(device):
                current = torch.cuda.current_stream()
                # The inputs' own strides: a layout (a solver's column-major
                # result) can choose another kernel, with other bits.
                inputs = [torch.empty_like(t).copy_(t) for t in leaves]
                stream = _capture_stream(device)
                stream.wait_stream(current)
                graph = torch.cuda.CUDAGraph()
                _local.busy = True
                try:
                    with torch.cuda.stream(stream):
                        self._run(statics, spec, inputs)  # warm-up, counted as it runs
                        _local.tally = {}
                        graph.capture_begin(capture_error_mode="thread_local")
                        try:
                            out = self._run(statics, spec, inputs)
                        except BaseException:
                            _end_failed_capture(graph)
                            raise
                        graph.capture_end()
                        launches = _local.tally
                finally:
                    _local.busy = False
                    _local.tally = None
                current.wait_stream(stream)
            outputs: list = []
            out_spec = _flatten(out, outputs)
            entry = _Entry(graph, inputs, outputs, out_spec, launches, threading.Lock())
            with _lock:
                self._entries[key] = entry
                self.captures += 1
            _bump(_UTILS, "graph_captures", 1)
            return entry

    def _replay(self, entry: _Entry, leaves):
        with entry.lock:
            for buf, x in zip(entry.inputs, leaves):
                buf.copy_(x)
            entry.graph.replay()
            fresh = [t.clone() for t in entry.outputs]
        for (module, counter), n in entry.launches.items():
            _bump(module, counter, n)
        _bump(_UTILS, "graph_replays", 1)
        return _unflatten(entry.out_spec, fresh)


_UTILS = __name__.rsplit(".", 1)[0]


def _key(statics, spec, leaves) -> tuple:
    return (statics, spec, tuple((tuple(t.shape), t.stride(), t.dtype) for t in leaves),
            torch.backends.cuda.matmul.allow_tf32)


def _leaves(x) -> list:
    leaves: list = []
    _flatten(x, leaves)
    return leaves


def _end_failed_capture(graph) -> None:
    """End a capture whose function raised; the function's error is the
    one reported."""
    try:
        graph.capture_end()
    except RuntimeError:
        pass


def graphed_functions() -> dict:
    """The graphed functions bound at module level in the port's loaded
    modules, by 'module.attribute' below the package (one name each: the
    module that defines it where it is bound there). A run's captures per
    function are read off them (`Graphed.captures`)."""
    package = __name__.split(".")[0]
    names: dict = {}
    for modname, mod in sorted(sys.modules.items()):
        if mod is None or not (modname == package or modname.startswith(package + ".")):
            continue
        for attr, value in sorted(vars(mod).items()):
            if isinstance(value, Graphed):
                name = f"{modname[len(package) + 1:]}.{attr}"
                if id(value) not in names or modname == value.__module__:
                    names[id(value)] = (name, value)
    return dict(sorted(names.values(), key=lambda nv: nv[0]))


def graphed(fn: Callable, static_argnames=(), max_entries: Optional[int] = None) -> Graphed:
    """Put `fn` behind the graph cache (see the module docstring): the
    counterpart of `jax.jit(fn, static_argnames=...)`. `max_entries` bounds
    the captures kept (the newest; None keeps every one)."""
    return Graphed(fn, static_argnames, max_entries)
