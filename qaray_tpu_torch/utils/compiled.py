"""Captured execution on the card: the counterpart of jax.jit.

The JAX package compiles its hot path into XLA programs (jax.jit over
render_batch, the device folds, the gradient step and the photon batch).
Here the same functions are captured as CUDA graphs and replayed.
`jit(fn, static_argnames=..., inputs=..., state=...)` wraps fn:

- On the first call for a key the wrapper runs fn eagerly once on a side
  stream (which builds and loads the kernels, ops/_build.py, and does every
  lazy set-up outside the capture), captures fn in a torch.cuda.CUDAGraph
  and replays it. Later calls with the same key copy the per-call tensors
  into the graph's static inputs, replay it and return copies of its
  outputs (a replay overwrites the graph's own, and the Renderer holds one
  dispatch's outputs while the next one runs).
- The key holds the static arguments, the route switches the callee reads
  at call time (ROUTE_SWITCHES), the shape, dtype and device of every
  tensor argument, the storage of the `state` arguments (which fn updates
  in place: the graph writes into them), and every host value the capture
  bakes in: ints, floats and strings among the arguments, and CPU tensors
  (a photon map's radius) by value.
- Tensor arguments named in `inputs` are copied into static buffers on
  every call. Every other tensor (the scene's tables, the photon maps) is a
  table: it is copied into a static buffer of its own when it is not the
  tensor last copied there or was changed in place since, and not
  otherwise. So a new camera (the server's /orbit), a new parameter step
  spliced into the material and light tables, or a recompiled scene of the
  same shapes replays the graph it has; the table buffers are shared by
  the graphs of one function, argument and shape.
- On CPU tensors fn is called directly: that is the device the caller
  asked for. So is a call that `eager_if` says cannot be captured (the
  plain walks on the card, whose loops end on a host read).
- A call on the card whose tensors require grad, with grad enabled, goes
  through an autograd Function (_Grad): its forward replays fn's graph
  without a tape, its backward replays a captured VJP step, by default fn
  re-run under autograd on leaves made from its table buffers and
  torch.autograd.grad of its outputs at the given cotangents
  (`recompute`; the whole-network capture of torch.cuda.graphs, whose
  backward kernels go to the capturing side stream); `vjp=` names another
  (render_batch's megakernel route takes the megakernel's backward). The
  step holds no tape between graphs. A function may also build such
  leaves and call torch.autograd.grad itself (diff._autograd_step): its
  capture holds the forward and the backward. A wrapped function called
  inside another's warm-up or capture runs as part of it, on its tape.
- On CUDA tensors a failed capture or replay raises; nothing falls back to
  eager on its own. The eager path is reachable only through the explicit
  switch, `eager()` or QARAY_EAGER=1, as jax.disable_jit is in JAX: tests
  and chip_smoke.py compare the two.

All graphs of a device share one memory pool: they replay one at a time on
one stream, their static inputs and tables live outside the pool, and
their outputs are copied out right after each replay. The cache of a
wrapped function holds at most MAX_GRAPHS graphs, the least recently used
dropped first, and about MAX_TABLES table buffers. A replay adds the
launch counts its capture recorded to the kernels' counters (`launches`
of each ops module, ops/mtl_gather's backward `stats`, ops/threefry's
folds and draws and the engine's wavefront_lanes), so that a call counts
the launches of one run of the function, replayed or not; the warm-up's,
made once a graph as part of capturing it, are not counted.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import inspect
import os
from collections import OrderedDict
from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree

from qaray_tpu_torch.utils.timing import span

# The switches the captured functions read at call time: part of the key.
ROUTE_SWITCHES = ("QARAY_NO_MEGAKERNEL", "QARAY_MESH_PATH", "QARAY_BVH_WALK",
                  "QARAY_NO_PALLAS", "QARAY_STREAM_MAX_TRIS",
                  "QARAY_MEGA_STREAM_MAX_TRIS", "QARAY_MEGA_MESH_MAX_TRIS",
                  "QARAY_NO_WORLD_BVH", "QARAY_BVH")
MAX_GRAPHS = 64
# Table buffers a wrapped function may hold before its graphs and buffers
# are dropped together (scenes of many shapes).
MAX_TABLES = 4096
# CPU tensors among the arguments of a call on the card are host values,
# keyed by value: at most this many elements.
HOST_VALUE_NUMEL = 64

# Counters a replay adds to: (module, attribute) of a dict of counts or of
# an int.
_COUNTERS = (("qaray_tpu_torch.ops.analytic", "launches"),
             ("qaray_tpu_torch.ops.megakernel", "launches"),
             ("qaray_tpu_torch.ops.mesh_sweep", "launches"),
             ("qaray_tpu_torch.ops.tiles", "launches"),
             ("qaray_tpu_torch.ops.photon", "launches"),
             ("qaray_tpu_torch.ops.adjoint", "launches"),
             ("qaray_tpu_torch.ops.bvh_packed", "launches"),
             ("qaray_tpu_torch.ops.bvh_packed", "stats"),
             ("qaray_tpu_torch.ops.mtl_gather", "launches"),
             ("qaray_tpu_torch.ops.mtl_gather", "stats"),
             ("qaray_tpu_torch.ops.threefry", "launches"),
             ("qaray_tpu_torch.ops.threefry", "stats"),
             ("qaray_tpu_torch.integrators.engine", "wavefront_lanes"))

# Over every wrapped function: graphs captured, replays, seconds spent in
# warm-up and capture (the spans `capture`).
stats = {"captures": 0, "replays": 0, "capture_s": 0.0}

_eager_depth = 0
# Depth of warm-ups and captures running: a wrapped function called from
# inside another's runs as part of it.
_active = 0
_pools = {}
_side_streams = {}
_wrapped = []


@contextlib.contextmanager
def eager():
    """Run every wrapped function eagerly within the block (jax.disable_jit's
    counterpart)."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


def is_eager() -> bool:
    return _eager_depth > 0 or bool(os.environ.get("QARAY_EAGER"))


def graph_count() -> int:
    """Graphs held now, over every wrapped function."""
    return sum(len(w._graphs) for w in _wrapped)


def _pool(device):
    if device not in _pools:
        with torch.cuda.device(device):
            _pools[device] = torch.cuda.graph_pool_handle()
    return _pools[device]


def _side_stream(device):
    """The stream of a device's warm-ups and captures."""
    if device not in _side_streams:
        _side_streams[device] = torch.cuda.Stream(device)
    return _side_streams[device]


def _snapshot():
    out = {}
    for mod, attr in _COUNTERS:
        val = getattr(importlib.import_module(mod), attr)
        if isinstance(val, dict):
            for k, v in val.items():
                out[(mod, attr, k)] = v
        else:
            out[(mod, attr, None)] = val
    return out


def _restore(snap):
    for (mod, attr, k), v in snap.items():
        m = importlib.import_module(mod)
        if k is None:
            setattr(m, attr, v)
        else:
            getattr(m, attr)[k] = v


def _add(delta):
    for (mod, attr, k), v in delta:
        m = importlib.import_module(mod)
        if k is None:
            setattr(m, attr, getattr(m, attr) + v)
        else:
            getattr(m, attr)[k] += v


class _Slot:
    """A table's static buffer and the tensor last copied into it."""

    __slots__ = ("buf", "src", "version")

    def __init__(self, buf):
        self.buf = buf
        self.src = None
        self.version = None

    def refresh(self, t):
        if self.src is not t or self.version != t._version:
            self.buf.copy_(t)
            self.src = t
            self.version = t._version


class _Desc(NamedTuple):
    """An argument flattened: its leaves and tree, the key parts of its
    leaves, how each is made static ("input", "state", "table" or None for
    a host value), the devices of its tensors, and a CPU tensor too large
    to key by value (None where there is none)."""

    leaves: list
    spec: object
    parts: tuple
    kinds: list
    devices: set
    too_large: object


def _wrt(names, descs):
    """The tensors of a call that require grad: ((argument, leaf indices)
    pairs, the tensors in that order)."""
    wrt, leaves = [], []
    for n, d in zip(names, descs):
        idx = tuple(i for i, x in enumerate(d.leaves)
                    if isinstance(x, torch.Tensor) and x.requires_grad)
        if idx:
            wrt.append((n, idx))
            leaves += [d.leaves[i] for i in idx]
    return tuple(wrt), leaves


def _recompute_fn(fn):
    """fn's VJP by re-running it under autograd: a function of fn's
    arguments, `wrt` ((argument, leaf indices) pairs, as _wrt gives them)
    and `cts` (a cotangent or None for each of fn's flattened outputs) that
    returns the gradients of those leaves, zeros where none reaches one."""

    def recompute(**kw):
        wrt, cts = kw.pop("wrt"), kw.pop("cts")
        leaves = []
        for n, idx in wrt:
            flat, spec = pytree.tree_flatten(kw[n])
            for i in idx:
                flat[i] = flat[i].detach().requires_grad_()
                leaves.append(flat[i])
            kw[n] = pytree.tree_unflatten(flat, spec)
        with torch.enable_grad():
            pairs = [(o, c) for o, c in zip(pytree.tree_leaves(fn(**kw)), cts)
                     if c is not None and o.requires_grad]
            grads = (torch.autograd.grad([o for o, _ in pairs], leaves,
                                         [c for _, c in pairs],
                                         allow_unused=True)
                     if pairs else [None] * len(leaves))
        return tuple(torch.zeros_like(x) if g is None else g
                     for x, g in zip(leaves, grads))

    sig = inspect.signature(fn)
    recompute.__signature__ = sig.replace(parameters=[
        *sig.parameters.values(),
        *(inspect.Parameter(n, inspect.Parameter.KEYWORD_ONLY, default=None)
          for n in ("wrt", "cts"))])
    recompute.__name__ = f"{fn.__name__}_vjp"
    return recompute


class _Grad(torch.autograd.Function):
    """A wrapped function under its caller's autograd: the forward calls
    the wrapper with no tape (a replay on the card), the backward its VJP
    step (Compiled.vjp) at the outputs' cotangents. spec receives the
    outputs' tree."""

    @staticmethod
    def forward(ctx, wrapped, arguments, wrt, spec, *leaves):
        ctx.set_materialize_grads(False)
        ctx.wrapped, ctx.arguments, ctx.wrt = wrapped, arguments, wrt
        out, tree = pytree.tree_flatten(wrapped(**arguments))
        spec.append(tree)
        ctx.mark_non_differentiable(*(
            x for x in out
            if isinstance(x, torch.Tensor) and not x.is_floating_point()))
        return tuple(out)

    @staticmethod
    def backward(ctx, *cts):
        return (None,) * 4 + tuple(ctx.wrapped.vjp(ctx.arguments, ctx.wrt,
                                                   cts))


class _Graph:
    """A captured graph, its static inputs and table slots, the state it
    updates (held, so that the storage it is keyed on stays its own), its
    outputs and the launch counts a replay adds."""

    __slots__ = ("graph", "inputs", "slots", "state", "out_leaves",
                 "out_spec", "delta")


class Compiled:
    """A function wrapped by jit(); see the module's docstring."""

    def __init__(self, fn, static_argnames=(), inputs=(), state=(),
                 eager_if=None, vjp=None):
        self.fn = fn
        params = inspect.signature(fn).parameters.values()
        self._defaults = {p.name: p.default for p in params}
        self.static = frozenset(static_argnames)
        self.inputs = frozenset(inputs)
        self.state = frozenset(state)
        self.eager_if = eager_if
        self._vjp = vjp
        self._recompute = None
        self._graphs = OrderedDict()
        self._tables = {}
        # The last description of each tuple argument (the scene, the
        # maps), reused while the caller passes the same object.
        self._memo = {}
        functools.update_wrapper(self, fn)
        _wrapped.append(self)

    def _bind(self, args, kwargs):
        arguments = dict(self._defaults)
        if len(args) > len(arguments):
            raise TypeError(f"{self.__name__}: too many arguments")
        arguments.update(zip(arguments, args))
        for k, v in kwargs.items():
            if k not in arguments:
                raise TypeError(f"{self.__name__}: no argument {k!r}")
            arguments[k] = v
        for k, v in arguments.items():
            if v is inspect.Parameter.empty:
                raise TypeError(f"{self.__name__}: missing argument {k!r}")
        return arguments

    def _describe(self, n, obj) -> _Desc:
        """Argument n flattened and described (_Desc)."""
        memo = self._memo.get(n)
        if memo is not None and memo[0] is obj:
            return memo[1]
        leaves, spec = pytree.tree_flatten(obj)
        parts, kinds, devices, too_large = [(n, str(spec))], [], set(), None
        for x in leaves:
            if not isinstance(x, torch.Tensor):
                parts.append(x)
                kinds.append(None)
            elif x.device.type == "cpu":
                if x.numel() > HOST_VALUE_NUMEL:
                    too_large = (f"argument {n!r} holds a CPU tensor of "
                                 f"{x.numel()} elements")
                    parts.append(x)
                else:
                    parts.append(("host", x.dtype, tuple(x.shape),
                                  tuple(x.reshape(-1).tolist())))
                kinds.append(None)
            else:
                devices.add(x.device)
                if n in self.state:
                    parts.append(("state", x.data_ptr(), x.dtype,
                                  tuple(x.shape), x.stride()))
                    kinds.append("state")
                else:
                    parts.append((x.dtype, tuple(x.shape)))
                    kinds.append("input" if n in self.inputs else "table")
        desc = _Desc(leaves, spec, tuple(parts), kinds, devices, too_large)
        if isinstance(obj, tuple) and n not in self.inputs:
            self._memo[n] = (obj, desc)
        return desc

    def _prepare(self, args, kwargs):
        """(arguments, dynamic names, their descriptions, the device of the
        call or None where fn runs directly)."""
        arguments = self._bind(args, kwargs)
        names = [n for n in arguments if n not in self.static]
        descs = [self._describe(n, arguments[n]) for n in names]
        devices = set().union(*(d.devices for d in descs))
        device = None
        if devices:
            if len(devices) > 1:
                raise ValueError(f"{self.__name__}: tensors on "
                                 f"{sorted(map(str, devices))}")
            device = next(iter(devices))
        if (_active or is_eager() or (
                device is not None and device.type == "cuda"
                and torch.cuda.is_current_stream_capturing())
                or (self.eager_if is not None and self.eager_if(arguments))):
            device = None
        return arguments, names, descs, device

    def key_of(self, *args, **kwargs):
        """The key of a call, or None where the call runs fn directly (for
        tests: the arguments may be on the meta device)."""
        arguments, names, descs, device = self._prepare(args, kwargs)
        if device is None:
            return None
        return self._key(arguments, descs, device)

    def __call__(self, *args, **kwargs):
        arguments, names, descs, device = self._prepare(args, kwargs)
        if device is None:
            return self.fn(*args, **kwargs)
        if torch.is_grad_enabled():
            wrt, leaves = _wrt(names, descs)
            if wrt:
                return self._differentiate(arguments, wrt, leaves)
        key = self._key(arguments, descs, device)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._capture(key, arguments, names, descs, device)
        else:
            self._graphs.move_to_end(key)
            self._fill(entry, descs)
        with torch.cuda.device(device):
            entry.graph.replay()
        stats["replays"] += 1
        _add(entry.delta)
        return pytree.tree_unflatten(
            [x.clone() if isinstance(x, torch.Tensor) else x
             for x in entry.out_leaves], entry.out_spec)

    # -- under the caller's autograd ------------------------------------------

    def differentiable(self, *args, **kwargs):
        """fn under the caller's autograd through _Grad, on any device: the
        route a call on the card takes where a tensor argument requires
        grad (on the CPU a call runs fn on the caller's tape; tests call
        this there)."""
        arguments = self._bind(args, kwargs)
        names = [n for n in arguments if n not in self.static]
        wrt, leaves = _wrt(names, [self._describe(n, arguments[n])
                                   for n in names])
        return self._differentiate(arguments, wrt, leaves)

    def _differentiate(self, arguments, wrt, leaves):
        spec = []
        out = _Grad.apply(self, arguments, wrt, spec, *leaves)
        return pytree.tree_unflatten(list(out), spec[0])

    def vjp(self, arguments, wrt, cts):
        """The gradients of the wrt leaves of a call's arguments for the
        cotangents cts of its flattened outputs: vjp(arguments, wrt, cts)
        where jit() was given one, else recompute."""
        if self._vjp is not None:
            return self._vjp(arguments, wrt, cts)
        return self.recompute(arguments, wrt, cts)

    def recompute(self, arguments, wrt, cts):
        """The VJP by fn re-run under autograd (_recompute_fn), captured as
        a function of its own: wrt static, the cotangents inputs."""
        if self._recompute is None:
            self._recompute = Compiled(
                _recompute_fn(self.fn), self.static | {"wrt"},
                self.inputs | {"cts"}, eager_if=self.eager_if)
        return self._recompute(**arguments, wrt=wrt, cts=cts)

    def _key(self, arguments, descs, device):
        for d in descs:
            if d.too_large:
                raise ValueError(f"{self.__name__}: {d.too_large} in a call "
                                 f"on {device}")
        return (tuple((n, arguments[n]) for n in sorted(self.static)),
                tuple(os.environ.get(s) for s in ROUTE_SWITCHES), device,
                tuple(d.parts for d in descs))

    # -- static buffers ------------------------------------------------------

    def _slot(self, device, name, spec, i, x):
        k = (device, name, str(spec), i, x.dtype, tuple(x.shape))
        slot = self._tables.get(k)
        if slot is None:
            slot = self._tables[k] = _Slot(
                torch.empty(x.shape, dtype=x.dtype, device=device))
        return slot

    def _fill(self, entry, descs):
        """Copy this call's inputs, and its tables where they changed, into
        the entry's static buffers."""
        inputs, slots = iter(entry.inputs), iter(entry.slots)
        for d in descs:
            for kind, x in zip(d.kinds, d.leaves):
                if kind == "input":
                    next(inputs).copy_(x)
                elif kind == "table":
                    next(slots).refresh(x)

    def _static_args(self, entry, arguments, names, descs, device):
        """The arguments the graph is captured with, and those of its
        warm-up (the same with copies of the state)."""
        entry.inputs, entry.slots, entry.state = [], [], []
        static, warm = dict(arguments), dict(arguments)
        for n, d in zip(names, descs):
            out, scratch = [], []
            for i, (kind, x) in enumerate(zip(d.kinds, d.leaves)):
                if kind == "input":
                    buf = torch.empty(x.shape, dtype=x.dtype, device=device)
                    buf.copy_(x)
                    entry.inputs.append(buf)
                    out.append(buf)
                elif kind == "table":
                    slot = self._slot(device, n, d.spec, i, x)
                    slot.refresh(x)
                    entry.slots.append(slot)
                    out.append(slot.buf)
                else:
                    if kind == "state":
                        entry.state.append(x)
                    out.append(x)
                # The warm-up updates copies of the state, not the state.
                scratch.append(x.clone() if kind == "state" else out[-1])
            static[n] = pytree.tree_unflatten(out, d.spec)
            warm[n] = pytree.tree_unflatten(scratch, d.spec)
        return static, warm

    # -- capture ---------------------------------------------------------------

    def _capture(self, key, arguments, names, descs, device):
        global _active
        with span("capture") as timed:
            if len(self._tables) > MAX_TABLES:
                self._graphs.clear()
                self._tables.clear()
            entry = _Graph()
            _active += 1
            try:
                with torch.cuda.device(device):
                    static, warm = self._static_args(entry, arguments, names,
                                                     descs, device)
                    out, delta = self._warm_and_capture(entry, static, warm,
                                                        device)
            finally:
                _active -= 1
            entry.delta = delta
            entry.out_leaves, entry.out_spec = pytree.tree_flatten(out)
            self._graphs[key] = entry
            while len(self._graphs) > MAX_GRAPHS:
                self._graphs.popitem(last=False)
        stats["captures"] += 1
        stats["capture_s"] += timed.seconds
        return entry

    def _warm_and_capture(self, entry, static, warm, device):
        """Run fn once eagerly on `warm` (static with copies of the state),
        then capture it on `static` into entry.graph, both on the device's
        side stream; returns (the graph's outputs, the launch counts its
        replays add)."""
        cur = torch.cuda.current_stream(device)
        side = _side_stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            # Warm-up: builds and loads the kernels and runs every lazy
            # set-up (constant-memory uploads, function attributes, library
            # handles) outside the capture.
            start = _snapshot()
            self.fn(**warm)
            before = _snapshot()
            # torch.cuda.graph's capture without its gc.collect() and
            # empty_cache(), which would cost every capture.
            entry.graph = torch.cuda.CUDAGraph()
            entry.graph.capture_begin(pool=_pool(device))
            try:
                out = self.fn(**static)
            finally:
                entry.graph.capture_end()
                after = _snapshot()
                _restore(start)
        cur.wait_stream(side)
        delta = tuple((k, after[k] - v) for k, v in before.items()
                      if after[k] != v)
        return out, delta


def jit(fn=None, *, static_argnames=(), inputs=(), state=(), eager_if=None,
        vjp=None):
    """Wrap fn for capture and replay on the card (see the module's
    docstring). static_argnames: arguments hashed into the key (meta, cfg,
    want_aux, ...); inputs: arguments whose tensors change every call (the
    lanes), copied in on every call; state: arguments fn updates in place,
    keyed on their storage; eager_if(arguments): True where a call cannot
    be captured; vjp(arguments, wrt, cts): the backward under a caller's
    autograd, where it is not fn re-run (Compiled.vjp)."""
    if fn is None:
        return functools.partial(jit, static_argnames=static_argnames,
                                 inputs=inputs, state=state,
                                 eager_if=eager_if, vjp=vjp)
    return Compiled(fn, static_argnames, inputs, state, eager_if, vjp)
