"""Compiled functions: the block step with donated state, the counterpart
of ``jax.jit(step, donate_argnums=0)`` (``rtsdr_tpu/pipeline/receiver.py``,
the JAX CLI's wideband loop, its channel-, wideband- and time-sharded
receivers), and any function without donation, the counterpart of
``jax.jit(fn)`` (the JAX CLI's band scanner, the stage table of
``utils/profiling.py``).  A step whose state lies on one device is one
``CompiledStep``; one over two or more devices is a ``ComposedStep`` of one
``CompiledStep`` per device.

``jit_step(init_fn, step_fn, device)`` returns ``(init_fn, step)`` with
``step(state, raw_u8) -> (state, outputs)`` as before.  On a CUDA device
the first call captures the step as one CUDA graph (``torch.cuda.CUDAGraph``)
and every call replays it:

* Capture.  Two eager warm-up steps (``WARMUP_STEPS``) run on a side
  stream over a scratch clone of the caller's state (the caller's state does not advance, as
  compiling in JAX runs nothing): they fill the tap and plan caches,
  cuBLAS's workspace and the kernels' one-time attribute calls.  Then the
  step is captured reading one static input buffer and one static state
  tree; at its end the graph copies the new state into that tree
  (``_foreach_copy_``), so the state is updated in place.  One graph and
  that copy, not two graphs A -> B and B -> A: PyTorch's operators allocate
  their results, so a captured step writes its new state wherever the
  allocator puts it, never into a tree chosen beforehand, and each of two
  graphs would need the same copy into the other's tree (PERF.md gives the
  copy's device time).  A capture that fails (a host synchronisation, a
  pageable copy, any call that cannot be captured) raises with the step's
  name; nothing falls back to the eager step.
* Donation.  The returned state is the static tree (fresh tensor objects
  viewing it).  Passing it back replays at once.  Any other tree (an
  ``init_fn()``, a ``load_state`` result, a converted JAX state) is copied
  into the static tree first.  A tree this step returned before its latest
  call is consumed: its memory now holds a later state, and passing it
  raises, as a donated JAX array is deleted.  A consumed tree's tensors are
  emptied (``set_()``): reading one fails rather than reading that later
  state, so a caller that wants to keep a state clones it before the next
  call.  One compiled step holds one live state.
* Outputs.  ``step`` returns clones of the graph's output buffers: they
  belong to the caller, as JAX's outputs are fresh arrays.
  ``step.borrowed`` returns the buffers themselves, valid until the next
  call; only loops that enqueue the fetch of every output before their next
  step use it (``io/stream.py``, ``io/batch.py``, the CLI's wideband loop).
* Pinning.  The graph reads device memory that the caches of
  ``ops/fir.py::DeviceCache`` hold (taps, plans); a cache that turns over
  drops its values.  The step keeps every value the caches held at the end
  of the capture for the graph's lifetime.
* Launch counts.  The warm-up's and the capture's launches are compile-time
  work and are taken back out of ``ops/_cuda.py``'s ``LAUNCHES``; each
  replay adds the launches its capture recorded, so a window counts the
  same launches per step compiled or eager.
* Spans.  The warm-up and capture together are one ``rtsdr.capture`` span
  of ``utils/trace.py``, each replay one ``rtsdr.replay`` (its
  ``launches``: the sum of ``per_step``).

``jit_fn(fn, device)`` returns a ``CompiledFn``: ``fn(*args)`` captured in
the same way (the warm-ups, then one graph; pinning and launch counts as
above) over static copies of its tensor arguments.  Nothing is donated:
each call copies every argument that is not already its static buffer into
that buffer, replays, and returns clones of the outputs (``borrowed``: the
graph's buffers).  Calling again with the same tensors is the normal case,
and ``static_args()`` hands out the buffers for a caller that writes its
inputs straight into them.  A call with other shapes or dtypes than the
capture's raises.

``ComposedStep(parts, split, merge, feed, gather, name)``: a step whose
state spans devices, as a mesh over several GPUs holds it, compiled as one
``CompiledStep`` per device (its docstring); the sharded receivers build
one part per distinct device of their mesh (``device_groups``).  Within
one capture a step may fork work onto other streams of its device and
join them (the spread route of ``parallel/timeshard.py``): the graph then
holds the forked branches.

On the CPU (``device='cpu'``) both wrappers run the function eagerly each
call and write its results into their static buffers, so the donation,
ownership and launch-count rules run, and are tested, without a card.
"""

from __future__ import annotations

import contextlib

import torch

from rtsdr_tpu_torch.device import resolve_device
from rtsdr_tpu_torch.ops import _cuda
from rtsdr_tpu_torch.ops.fir import DeviceCache
from rtsdr_tpu_torch.utils.trace import annotate

#: eager warm-up steps before a capture, by device type: on a GPU they fill
#: the tap and plan caches, cuBLAS's workspace and the kernels' one-time
#: attribute calls, none of which a capture admits; the CPU has none of
#: these
WARMUP_STEPS = {"cuda": 2, "cpu": 0}


_TENSOR = object()   # a tensor's place in a template


def _flatten(tree, leaves: list):
    """Append ``tree``'s tensors to ``leaves``; returns the template that
    ``_build`` fills back (tuples, NamedTuples and lists are nodes; any
    other value stays as it is)."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _TENSOR
    if isinstance(tree, (tuple, list)):
        return (type(tree), [_flatten(v, leaves) for v in tree])
    return (None, tree)


def _build(template, it):
    if template is _TENSOR:
        return next(it)
    kind, kids = template
    if kind is None:
        return kids
    vals = [_build(k, it) for k in kids]
    return kind(*vals) if hasattr(kind, "_fields") else kind(vals)


def flatten(tree) -> tuple[list, object]:
    """``(tensors, template)`` of a state or output tree."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def unflatten(template, leaves):
    """The tree of ``template`` with ``leaves`` in its tensors' places."""
    return _build(template, iter(leaves))


def copy_all(dsts: list, srcs: list) -> None:
    """``dst.copy_(src)`` for each pair, one ``_foreach_copy_`` per dtype:
    a few multi-tensor copy kernels, where a list of mixed dtypes falls
    back to one copy per pair (a C = 1 step's copy-back and output copies
    were 48 graph nodes and launches, 0.05 ms of its 0.70 ms of device
    time on an H100; grouped, 0.64 ms in all, PERF.md)."""
    groups: dict = {}
    for d, s in zip(dsts, srcs):
        g = groups.setdefault(d.dtype, ([], []))
        g[0].append(d)
        g[1].append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def _overlaps(t: torch.Tensor, storages: set) -> bool:
    return t.untyped_storage().data_ptr() in storages


def _owned(tree):
    """A tree of fresh tensors equal to ``tree``'s: what a caller keeps."""
    leaves, tmpl = flatten(tree)
    owned = [torch.empty_like(t) for t in leaves]
    copy_all(owned, leaves)
    return unflatten(tmpl, owned)


class _Recorded:
    """What the compiled forms share: after the warm-ups, one body recorded
    as a CUDA graph on a CUDA device (run once on the CPU), then replayed;
    its output buffers, the launch counts it recorded and the cache values
    it reads.  A subclass gives ``_body`` (returns the output leaves and
    their template) and ``_warm_up``; ``_static`` holds its input
    leaves."""

    def __init__(self, device, name: str):
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        self.name = name
        self._static = None      # static input leaves
        self._out = None         # static output leaves
        self._out_tmpl = None
        self._graph = None
        self._pinned = None      # cache values the graph reads
        self.per_step: dict = {}  # kernel launches one replay makes

    def _own_outputs(self, out):
        """Flatten ``out``; a leaf that views an input buffer is cloned (a
        later write of that input would change it)."""
        leaves, tmpl = flatten(out)
        storages = {t.untyped_storage().data_ptr() for t in self._static}
        return [o.clone() if _overlaps(o, storages) else o
                for o in leaves], tmpl

    def _capture(self) -> None:
        """Warm up, then record the body: on a CUDA device as a graph (run
        by the first replay), on the CPU by running it once."""
        counts = _cuda.launch_counts()
        try:
            with annotate("rtsdr.capture"), torch.no_grad():
                if self.cuda:
                    self._capture_graph()
                else:
                    self._warm_up()
                    _cuda.reset_launch_counts()
                    out, self._out_tmpl = self._body()
                    self.per_step = _cuda.launch_counts()
                    # the body's own outputs become the static buffers
                    self._out = [o.clone() for o in out]
        finally:
            _cuda.LAUNCHES.clear()
            _cuda.LAUNCHES.update(counts)

    def _capture_graph(self) -> None:
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.device(dev), torch.cuda.stream(side):
            self._warm_up()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        _cuda.reset_launch_counts()
        try:
            with torch.cuda.device(dev), torch.cuda.graph(graph):
                out, out_tmpl = self._body()
        except Exception as e:
            raise RuntimeError(
                f"{self.name}: CUDA graph capture failed on {dev} "
                f"({type(e).__name__}: {e}); a compiled step admits no host "
                "synchronisation and no pageable copy") from e
        self.per_step = _cuda.launch_counts()
        self._graph = graph
        self._out, self._out_tmpl = out, out_tmpl
        self._pinned = DeviceCache.held_values()

    def _replay(self) -> None:
        with annotate("rtsdr.replay") as span:
            if span:
                span.add(launches=sum(self.per_step.values()))
            if self._graph is not None:
                with torch.cuda.device(self.device):
                    self._graph.replay()
            else:
                counts = _cuda.launch_counts()
                with torch.no_grad():
                    out, _ = self._body()
                _cuda.LAUNCHES.clear()
                _cuda.LAUNCHES.update(counts)
                copy_all(self._out, out)
        _cuda.add_launches(self.per_step)

    def _run(self):
        """One call of the body over the static inputs; returns the output
        tree of the static output buffers."""
        if self._out is None:
            self._capture()
            if self.cuda:
                self._replay()
            else:      # the CPU ran the body in the capture
                _cuda.add_launches(self.per_step)
        else:
            self._replay()
        return unflatten(self._out_tmpl, self._out)


class CompiledStep(_Recorded):
    """``step(state, raw_u8)`` over one static state tree, replayed from a
    CUDA graph on a CUDA device (see the module's docstring)."""

    def __init__(self, init_fn, step_fn, device, name: str | None = None):
        super().__init__(device,
                         name or getattr(step_fn, "__qualname__", "step"))
        self.init_fn = init_fn
        self.step_fn = step_fn
        self.raw = None          # static input buffer
        self._tmpl = None        # the state tree's template
        self._gen = 0            # calls so far: tags the returned tree
        self._token = object()   # this step's mark on the trees it returns
        self._live: list = []    # the tensor objects of the returned tree
        self._state = None       # static state leaves

    # -- input -------------------------------------------------------------
    def input_buffer(self, shape, dtype=torch.uint8) -> torch.Tensor:
        """The static input buffer (made at the first request or call): a
        caller that writes each block straight into it saves the copy."""
        shape = torch.Size(shape)
        if self.raw is None:
            self.raw = torch.empty(shape, dtype=dtype, device=self.device)
        elif self.raw.shape != shape or self.raw.dtype != dtype:
            raise ValueError(
                f"{self.name}: compiled for input {tuple(self.raw.shape)} "
                f"{self.raw.dtype}, got {tuple(shape)} {dtype}")
        return self.raw

    def _take_input(self, raw) -> None:
        if not isinstance(raw, torch.Tensor):
            raw = torch.as_tensor(raw)
        dst = self.input_buffer(raw.shape, raw.dtype)
        if raw is not dst:
            dst.copy_(raw)

    # -- state -------------------------------------------------------------
    def check_donated(self, state) -> None:
        """Raise if ``state`` holds a tree this step returned before its
        latest call (donated, so its buffers now hold a later state)."""
        if any(tag[0] is self._token and tag[1] != self._gen
               for tag in (getattr(t, "_rtsdr_jit", None) or (None, 0)
                           for t in flatten(state)[0])):
            raise RuntimeError(
                f"{self.name}: this state was donated to an earlier call of "
                "the compiled step and its buffers now hold a later state; "
                "pass the state the last call returned (or jit=False)")

    def _take_state(self, state) -> None:
        self.check_donated(state)
        leaves, _ = flatten(state)
        if self._static is None:
            # the static tree: one contiguous tensor per leaf, laid out as
            # init_fn's (no two leaves share memory: the copy-back writes
            # every leaf), then the input block
            init, self._tmpl = flatten(self.init_fn())
            self._state = [t.detach().clone(
                memory_format=torch.contiguous_format) for t in init]
            self._static = [*self._state, self.raw]
        if len(leaves) != len(self._state):
            raise ValueError(
                f"{self.name}: state has {len(leaves)} tensors, the "
                f"compiled step's {len(self._state)}")
        # a foreign tree, or one that mixes the live tree's tensors with
        # new ones: copy in what is not already the static tree's
        live = self._live or [None] * len(leaves)
        for i, (dst, src, own) in enumerate(zip(self._state, leaves, live)):
            if src is own:
                continue
            if src.shape != dst.shape:
                raise ValueError(
                    f"{self.name}: state leaf {i} has shape "
                    f"{tuple(src.shape)}, the compiled step's "
                    f"{tuple(dst.shape)}")
            dst.copy_(src)

    def _returned_state(self):
        # the tree returned before is consumed: its tensors (views of the
        # static tree, objects of their own) are emptied, so reading it
        # fails as reading a donated JAX array does, never giving a later
        # state; the static tree itself is untouched
        with torch.no_grad():
            for old in self._live:
                old.set_()
        self._gen += 1
        tag = (self._token, self._gen)
        live = []
        for t in self._state:
            a = t.detach()
            a._rtsdr_jit = tag
            live.append(a)
        self._live = live
        return unflatten(self._tmpl, live)

    # -- the step body: what the graph holds ------------------------------
    def _body(self):
        """One step over the static buffers; the new state is copied back
        into the static tree at the end.  Returns the output leaves."""
        new, out = self.step_fn(unflatten(self._tmpl, self._state), self.raw)
        new_leaves, _ = flatten(new)
        if len(new_leaves) != len(self._state):
            raise ValueError(f"{self.name}: the step's new state has "
                             f"{len(new_leaves)} tensors, its input "
                             f"{len(self._state)}")
        storages = {t.untyped_storage().data_ptr() for t in self._state}
        dsts, srcs = [], []
        for i, (n, s) in enumerate(zip(new_leaves, self._state)):
            if n.shape != s.shape or n.dtype != s.dtype:
                raise ValueError(
                    f"{self.name}: state leaf {i} comes back "
                    f"{n.dtype} {tuple(n.shape)}, went in {s.dtype} "
                    f"{tuple(s.shape)}")
            if n is s:
                continue
            # a new leaf that views an old one would be read after the
            # copy-back overwrote it
            dsts.append(s)
            srcs.append(n.clone() if _overlaps(n, storages) else n)
        out_leaves, out_tmpl = self._own_outputs(out)
        copy_all(dsts, srcs)
        return out_leaves, out_tmpl

    def _warm_up(self) -> None:
        """Eager steps over a scratch clone of the static state: the
        static state does not advance."""
        scratch = unflatten(self._tmpl, [t.clone() for t in self._state])
        for _ in range(WARMUP_STEPS.get(self.device.type, 0)):
            scratch, _ = self.step_fn(scratch, self.raw)

    def borrowed(self, state, raw_u8):
        """``(state, outputs)`` with the outputs the graph's own buffers,
        overwritten by the next call: for loops that enqueue the fetch of
        every output before their next step."""
        self._take_input(raw_u8)
        self._take_state(state)
        out = self._run()
        return self._returned_state(), out

    def __call__(self, state, raw_u8):
        state, out = self.borrowed(state, raw_u8)
        return state, _owned(out)


class CompiledFn(_Recorded):
    """``fn(*args)`` replayed from a CUDA graph over static copies of its
    tensor arguments, none of them donated: the counterpart of
    ``jax.jit(fn)`` (see the module's docstring)."""

    def __init__(self, fn, device, name: str | None = None):
        super().__init__(device, name or getattr(fn, "__qualname__", "fn"))
        self.fn = fn
        self._tmpl = None        # the argument tuple's template

    def static_args(self) -> tuple:
        """The static argument buffers (after the first call): a caller
        that writes its arguments straight into them, or passes them back,
        saves the copies."""
        if self._static is None:
            raise RuntimeError(f"{self.name}: not called yet")
        return unflatten(self._tmpl, self._static)

    def _take_args(self, args) -> None:
        leaves, tmpl = flatten(tuple(args))
        if self._static is None:
            self._tmpl = tmpl
            self._static = [t.detach().to(
                self.device, copy=True, memory_format=torch.contiguous_format)
                for t in leaves]
            return
        if tmpl != self._tmpl:
            raise ValueError(f"{self.name}: called with arguments of "
                             "another structure than at the capture")
        for i, (dst, src) in enumerate(zip(self._static, leaves)):
            if src is dst:
                continue
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(
                    f"{self.name}: compiled for argument tensor {i} "
                    f"{dst.dtype} {tuple(dst.shape)}, got {src.dtype} "
                    f"{tuple(src.shape)}")
            dst.copy_(src)

    def _body(self):
        return self._own_outputs(self.fn(*self.static_args()))

    def _warm_up(self) -> None:
        args = self.static_args()
        for _ in range(WARMUP_STEPS.get(self.device.type, 0)):
            self.fn(*args)

    def borrowed(self, *args):
        """The outputs as the graph's own buffers, overwritten by the next
        call."""
        self._take_args(args)
        return self._run()

    def __call__(self, *args):
        return _owned(self.borrowed(*args))


def jit_step(init_fn, step_fn, device, name: str | None = None):
    """``(init_fn, step)``: ``step`` is ``step_fn`` compiled with its state
    donated (``CompiledStep``), ``init_fn`` unchanged."""
    return init_fn, CompiledStep(init_fn, step_fn, device, name)


def jit_fn(fn, device, name: str | None = None) -> CompiledFn:
    """``fn`` compiled without donation (``CompiledFn``): the counterpart
    of ``jax.jit(fn)``."""
    return CompiledFn(fn, device, name)


class ComposedStep:
    """A step over state that lies on two or more devices: one
    ``CompiledStep`` per device (a *part*), composed, as XLA compiles one
    program per device of a mesh for ``jax.jit(step, donate_argnums=0)``.
    A part holds the work of every shard on its device, reads its own
    static input buffer and keeps its own donated state tree.

    ``parts``: the ``CompiledStep``s, in the order they step;
    ``split(state)`` -> each part's state tree, ``merge(trees)`` -> the
    state; ``feed(k, raw, outs)`` -> part k's input from the block and the
    outputs of the parts before it (copied into part k's input buffer: a
    host-to-device, peer or local copy); ``gather(outs)`` -> the outputs,
    new tensors on one device.  A call writes each part's input and
    replays the parts in order, each with its device current.

    Donation holds across the parts: every part's tree is checked before
    any part steps, so passing a consumed state raises before anything
    runs; each part consumes and empties its own tree.  The gathered
    outputs are the caller's (``borrowed`` is the same call)."""

    def __init__(self, parts, split, merge, feed, gather, name: str):
        self.parts, self.name = list(parts), name
        self.split, self.merge = split, merge
        self.feed, self.gather = feed, gather

    @property
    def per_step(self) -> dict:
        """Kernel launches one call makes: the parts' replays."""
        total: dict = {}
        for part in self.parts:
            for k, n in part.per_step.items():
                total[k] = total.get(k, 0) + n
        return total

    def __call__(self, state, raw_u8):
        trees = self.split(state)
        for part, tree in zip(self.parts, trees):
            part.check_donated(tree)
        new, outs = [], []
        for k, (part, tree) in enumerate(zip(self.parts, trees)):
            guard = (torch.cuda.device(part.device) if part.cuda
                     else contextlib.nullcontext())
            with guard:
                tree, out = part.borrowed(tree, self.feed(k, raw_u8, outs))
            new.append(tree)
            outs.append(out)
        return self.merge(new), self.gather(outs)

    borrowed = __call__


def device_groups(devices) -> list:
    """``[(device, [shard indices])]``: the shards on each distinct device
    of ``devices``, in order of first use."""
    groups: dict = {}
    for i, d in enumerate(devices):
        groups.setdefault(torch.device(d), []).append(i)
    return list(groups.items())


def borrowing(step, shape):
    """``(call, input)`` for a loop that fetches every output before its
    next step: a compiled step's ``borrowed`` and its static input buffer of
    ``shape`` (uint8), or an eager ``step`` and None."""
    if isinstance(step, CompiledStep):
        return step.borrowed, step.input_buffer(shape)
    return step, None
