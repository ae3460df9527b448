"""CUDA graphs: when the port may use them (``applies``) and the one way it
captures and replays them (``Graphs``): the env step's post-physics tail
and its SEA torque-drive physics (envs/legged_env.py), and the PPO
update's minibatch step (rl/ppo.py).

``Graphs`` captures a chain of sections, functions of a namespace dict
(the inputs and the earlier sections' results: tensors, dicts, tuples,
dataclasses of them, None) that return a dict, as one CUDA graph each in
one memory pool, and replays them; the last section's dict is the
result.

- Inputs come in named groups of names; a caller stages each group when
  it changes (``stage``), so the update copies its batch once per
  iteration and its row indices once per step. A broadcast input (a
  stride 0) is staged into a dense buffer. ``fits`` says when the
  inputs, the generator or the tensors the sections change in place
  (``held``) are no longer those captured, and a new capture is due.
- Capture: the real call runs the sections eagerly on the staged buffers
  on the capture stream (kernels loaded, workspaces made), then the
  capture records them without running them, so no call is applied
  twice or skipped. The cyclic garbage collector is off while
  they record. Where there are no CUDA graphs (the CPU) ``capture``
  and each ``replay`` run the sections eagerly: the CPU tests drive the
  protocol so.
- Random numbers: every graph registers the caller's ``torch.Generator``,
  so a replay draws what the eager sections draw from its state at that
  moment, and leaves it where they leave it.
- Outputs are fresh tensors (``outputs``): nothing handed out aliases a
  buffer that a later replay or staging overwrites.
- A caller keeps its graphs from call to call: ``reuse`` gives them back
  where they fit the new inputs and builds new ones where they do not,
  and ``Graphs.run`` stages, captures the first time or replays after,
  and hands out the outputs.

A replay is only as valid as the host decisions the sections took while
capturing: the caller replays only where its host-side branches (the
env's pushes and command curriculum, the update's policy and
optimizer settings) take the captured path.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc

import torch

from legged_gym_tpu_torch.utils import profiling


def applies(device, mesh):
    """Whether the port may replay CUDA graphs: on a card, with the env
    axis whole (split over ranks, a step holds collectives: the update's
    gradient all-reduce, the env's finished-episode statistics)."""
    return device.type == "cuda" and mesh is None


def _span(name):
    """The span ``name`` (utils/profiling.py), or none where None."""
    return profiling.span(name) if name else contextlib.nullcontext()


def reuse(graphs, sections, inputs, generator=None, held=()):
    """The graphs to run on ``inputs``, ``generator`` and ``held``:
    ``graphs`` where they fit them (``Graphs.fits``: the inputs become
    their current ones), else new ``Graphs`` over them of the sections
    ``sections()`` gives (called only then), which their first ``run``
    captures."""
    if graphs is not None and graphs.fits(inputs, generator, held):
        return graphs
    return Graphs(sections(), inputs, generator, held)


def _flatten(x, leaves):
    """The structure of ``x`` with its tensors appended to ``leaves``."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return None
    if isinstance(x, dict):
        return (dict, tuple(x), tuple(_flatten(v, leaves)
                                      for v in x.values()))
    if isinstance(x, tuple):
        return (tuple, len(x), tuple(_flatten(v, leaves) for v in x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        names = tuple(f.name for f in dataclasses.fields(x))
        return (type(x), names, tuple(_flatten(getattr(x, n), leaves)
                                      for n in names))
    return ("const", x, ())


def _build(spec, leaves):
    if spec is None:
        return next(leaves)
    kind, keys, parts = spec
    if kind == "const":
        return keys
    if kind is dict:
        return {k: _build(p, leaves) for k, p in zip(keys, parts)}
    if kind is tuple:
        return tuple(_build(p, leaves) for p in parts)
    return kind(**{k: _build(p, leaves) for k, p in zip(keys, parts)})


def flatten(x):
    """(tensors of ``x`` in order, structure)."""
    leaves = []
    return leaves, _flatten(x, leaves)


def unflatten(spec, leaves):
    """``flatten``'s inverse: the structure ``spec`` over ``leaves``."""
    return _build(spec, iter(leaves))


def _layout(leaves, spec):
    return spec, tuple((t.shape, t.stride(), t.dtype) for t in leaves)


def _buffer(t):
    """A static buffer for inputs laid out as ``t``: of its strides, or
    dense where ``t`` is broadcast (a stride 0 repeats its elements, which
    a copy cannot write)."""
    if any(st == 0 and n > 1 for n, st in zip(t.shape, t.stride())):
        return torch.empty(t.shape, dtype=t.dtype, device=t.device)
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device=t.device)


def _by_dtype(tensors):
    """[(indices, tensors)] of ``tensors`` grouped by dtype."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return [(idx, [tensors[i] for i in idx]) for idx in groups.values()]


class Graphs:
    """``sections`` (functions of a namespace dict returning a dict)
    captured as one CUDA graph each over static buffers laid out as
    ``inputs`` ({group: dict of names}), drawing from ``generator`` (or
    None), changing the tensors ``held`` in place (or none). Built with
    ``inputs`` as the current inputs; ``capture`` runs and records the
    sections on what was staged."""

    def __init__(self, sections, inputs, generator=None, held=()):
        self.sections = list(sections)
        self.generator = generator
        self._inference = torch.is_inference_mode_enabled()
        # the held tensors are kept here, so no storage is freed and handed
        # to another tensor while the graphs write to it
        self._held = [(t, t.data_ptr()) for t in held]
        self._layouts, self._buffers, self._given = {}, {}, {}
        ns = {}
        for group, tree in inputs.items():
            leaves, spec = flatten(tree)
            self._layouts[group] = _layout(leaves, spec)
            self._given[group] = leaves
            bufs = [_buffer(t) for t in leaves]
            self._buffers[group] = _by_dtype(bufs)
            ns.update(unflatten(spec, bufs))
        self._ns = ns
        self.device = next(iter(self._given.values()))[0].device
        # where each input buffer sits: (group, index)
        self._at_input = {id(t): (g, i) for g, groups in
                          self._buffers.items() for idx, bufs in groups
                          for i, t in zip(idx, bufs)}
        self.graphs = None

    def fits(self, inputs, generator=None, held=()):
        """Whether these graphs run on ``inputs`` (structure, shapes,
        strides, dtypes of each group, inference mode), ``generator`` and
        ``held`` (the same tensors on the same storages). Where they do,
        ``inputs`` become the current inputs (what ``stage`` copies in and
        ``outputs`` passes through)."""
        if (generator is not self.generator
                or torch.is_inference_mode_enabled() != self._inference
                or len(held) != len(self._held)
                or any(t is not h or t.data_ptr() != p
                       for t, (h, p) in zip(held, self._held))
                or inputs.keys() != self._layouts.keys()):
            return False
        given = {}
        for group, tree in inputs.items():
            leaves, spec = flatten(tree)
            if _layout(leaves, spec) != self._layouts[group]:
                return False
            given[group] = leaves
        self._given = given
        return True

    def stage(self, group=None, tree=None):
        """Copy the current inputs of ``group`` (of every group when None)
        into the static buffers: those taken by ``fits``, the constructor
        or, with ``tree``, ``group``'s new inputs, of the captured layout,
        staged in their place."""
        if tree is not None:
            leaves, spec = flatten(tree)
            if _layout(leaves, spec) != self._layouts[group]:
                raise ValueError(f"inputs of group {group!r} are not laid "
                                 "out as captured")
            self._given[group] = leaves
        for g in (self._buffers if group is None else (group,)):
            given = self._given[g]
            for idx, bufs in self._buffers[g]:
                torch._foreach_copy_(bufs, [given[i] for i in idx])

    def _run(self, k):
        """Section ``k`` on the static buffers and the earlier sections'
        results, eagerly; the last section's result is the outputs'
        source."""
        v = self._ns if k == 0 else self._v
        out = self.sections[k](v)
        self._v = {**v, **out}
        if k == len(self.sections) - 1:
            self._v = None
            leaves, self._out_spec = flatten(out)
            self._plan(leaves)
            self._src = _by_dtype([leaves[j] for j in self._made])

    def _plan(self, leaves):
        """Per output leaf: ("in", (group, index)) for an input buffer
        passed through, ("same", index of the earlier output leaf it
        repeats) or ("copy", index into the copied leaves); ``_made``
        lists the copied leaves' positions, ``_through`` per group the
        inputs passed through."""
        first, self._how, self._made = {}, [], []
        self._through = {g: set() for g in self._layouts}
        for k, t in enumerate(leaves):
            if id(t) in self._at_input:
                g, i = self._at_input[id(t)]
                self._how.append(("in", (g, i)))
                self._through[g].add(i)
            elif id(t) in first:
                self._how.append(("same", first[id(t)]))
            else:
                first[id(t)] = k
                self._how.append(("copy", len(self._made)))
                self._made.append(k)

    def capture(self, spans=None):
        """The real call, then its capture: every section run eagerly on
        the staged buffers (``spans``: a ``profiling.span`` name per
        section, opened around its run), on the capture stream, then
        recorded as one graph each in one pool without running; the
        generator's state is left as the real call left it. The outputs
        are the real call's."""
        def run_all():
            for k in range(len(self.sections)):
                with _span(spans and spans[k]):
                    self._run(k)

        if self.device.type != "cuda":
            run_all()
            self.graphs = [None] * len(self.sections)
            return
        with torch.cuda.device(self.device):
            here = torch.cuda.current_stream()
            stream = torch.cuda.Stream()
            stream.wait_stream(here)
            with torch.cuda.stream(stream):
                run_all()
            here.wait_stream(stream)
            gen = self.generator
            drawn = gen.get_state() if gen is not None else None
            v, pool, graphs = self._ns, None, []
            # no cyclic garbage collection while recording: a collection
            # that destroys a dead cycle's graphs (a dead env's sections
            # refer to the env) inside a capture invalidates the capture
            collecting = gc.isenabled()
            gc.disable()
            try:
                for section in self.sections:
                    graph = torch.cuda.CUDAGraph()
                    if gen is not None:
                        graph.register_generator_state(gen)
                    with torch.cuda.graph(graph, pool=pool, stream=stream):
                        out = section(v)
                    v = {**v, **out}
                    pool = graph.pool()
                    graphs.append(graph)
            finally:
                if collecting:
                    gc.enable()
            if gen is not None:
                gen.set_state(drawn)
        leaves, _ = flatten(out)
        self._recorded = _by_dtype([leaves[j] for j in self._made])
        self.graphs = graphs

    def run(self, spans=None, span=None, stage=True):
        """The sections on the current inputs, staged first (all groups;
        none where ``stage`` is False, the caller having staged them):
        captured where nothing is captured yet (``capture``), else
        replayed, ``span`` open around the replay and ``spans[k]`` around
        section k's (the staging in the first, the outputs in the last).
        Returns (whether this call replayed, the fresh outputs)."""
        if self.graphs is None:
            if stage:
                self.stage()
            self.capture(spans)
            return False, self.outputs()
        last = len(self.sections) - 1
        with _span(span):
            for k in range(last + 1):
                with _span(spans and spans[k]):
                    if k == 0 and stage:
                        self.stage()
                    self.replay(k)
                    if k == last:
                        return True, self.outputs()

    def replay(self, k):
        """Replay section ``k``'s graph (run it eagerly where there are no
        graphs)."""
        if self.graphs[k] is None:
            self._run(k)
            return
        self.graphs[k].replay()
        self._src = self._recorded

    def outputs(self):
        """The last section's result of the latest run, as fresh tensors,
        one device copy each (one foreach copy per dtype); an input passed
        through unchanged is the caller's own tensor, and one tensor in the
        result stays one tensor. Of the caller's inputs only those passed
        through are kept after it (none outlives the caller's call): a
        later ``stage`` takes new ones."""
        fresh = [None] * len(self._made)
        for idx, src in self._src:
            got = [torch.empty_like(t) for t in src]
            torch._foreach_copy_(got, src)
            for i, t in zip(idx, got):
                fresh[i] = t
        out = []
        for how, k in self._how:
            if how == "in":
                out.append(self._given[k[0]][k[1]])
            else:
                out.append(out[k] if how == "same" else fresh[k])
        self._given = {g: {i: self._given[g][i] for i in idx}
                       for g, idx in self._through.items()}
        return unflatten(self._out_spec, out)

