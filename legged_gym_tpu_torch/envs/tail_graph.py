"""The env step's post-physics tail as CUDA graphs (envs/legged_env.py).

``TailGraphs`` captures a chain of sections, functions of tensors, as one
CUDA graph each in one memory pool, and replays them. Each section takes
the namespace of the inputs and the earlier sections' results (a dict of
tensors, dicts of tensors, dataclasses of tensors, tuples, None) and
returns a dict; the last one's dict is the tail's result.

- Inputs: ``match`` takes a step's inputs where they have the captured
  structure, shapes, strides and dtypes, in the same inference mode, with
  the same generator; ``stage`` copies them into the graphs' static input
  buffers (strides as the inputs had them when captured).
- Random numbers: every graph registers the env's ``torch.Generator``, so
  a replay draws from the generator's state at that moment what the eager
  sections draw from it, and leaves it where they leave it. Capture
  itself leaves the generator's state as it found it.
- Outputs: ``outputs`` hands out fresh tensors, one device copy each
  (the copies in and out are one foreach copy per dtype), so
  nothing returned aliases a buffer a later replay or staging overwrites;
  an output that is an input passed through unchanged is handed out as
  the caller's own tensor, with no copy. Outputs that are one tensor in
  the sections' result stay one tensor.

Replays are only as valid as the host decisions the sections took while
capturing: the caller replays only on steps whose host-side branches
(pushes, the command curriculum) match the captured step's.
"""
from __future__ import annotations

import dataclasses

import torch


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


def _signature(leaves, spec):
    return (torch.is_inference_mode_enabled(), spec,
            tuple((t.shape, t.stride(), t.dtype) for t in leaves))


class TailGraphs:
    """``sections`` (functions of a namespace dict returning a dict)
    captured on ``inputs`` as one CUDA graph each, drawing from
    ``generator``. Built right after the same sections ran eagerly on the
    same inputs, so every kernel they launch is loaded."""

    def __init__(self, sections, inputs, generator):
        leaves, spec = flatten(inputs)
        self.generator = generator
        self.signature = _signature(leaves, spec)
        # capture on the inputs' card, whichever is current
        with torch.no_grad(), torch.cuda.device(leaves[0].device):
            self._inputs = [torch.empty_strided(t.shape, t.stride(),
                                                dtype=t.dtype,
                                                device=t.device)
                            for t in leaves]
            v = unflatten(spec, self._inputs)
            drawn = generator.get_state()
            self.graphs, pool = [], None
            for section in sections:
                graph = torch.cuda.CUDAGraph()
                graph.register_generator_state(generator)
                with torch.cuda.graph(graph, pool=pool):
                    out = section(v)
                v = {**v, **out}
                pool = graph.pool()
                self.graphs.append(graph)
            generator.set_state(drawn)
        outs, self._out_spec = flatten(out)
        at_input = {id(t): i for i, t in enumerate(self._inputs)}
        first = {}
        # per output leaf: ("in", input index), ("same", index of the
        # earlier output leaf it repeats) or ("copy", index into _copied)
        self._plan, self._copied = [], []
        for k, t in enumerate(outs):
            if id(t) in at_input:
                self._plan.append(("in", at_input[id(t)]))
            elif id(t) in first:
                self._plan.append(("same", first[id(t)]))
            else:
                first[id(t)] = k
                self._plan.append(("copy", len(self._copied)))
                self._copied.append(t)
        # the copies in and out, one foreach copy per dtype
        self._in_groups = _by_dtype(self._inputs)
        self._out_groups = _by_dtype(self._copied)

    def match(self, inputs, generator):
        """The tensors of ``inputs`` (for ``stage`` and ``outputs``), or
        None where ``inputs`` or ``generator`` are not those the graphs
        were captured with (structure, shapes, strides, dtypes, inference
        mode)."""
        leaves, spec = flatten(inputs)
        if (generator is not self.generator
                or _signature(leaves, spec) != self.signature):
            return None
        return leaves

    def stage(self, leaves):
        """Copy the step's input tensors into the static input buffers."""
        for idx, bufs in self._in_groups:
            torch._foreach_copy_(bufs, [leaves[i] for i in idx])

    def replay(self, k):
        """Replay the graph of section ``k``."""
        self.graphs[k].replay()

    def outputs(self, leaves):
        """The last section's result of the latest replay, as fresh
        tensors; inputs passed through are the caller's ``leaves``."""
        fresh = [None] * len(self._copied)
        for idx, src in self._out_groups:
            got = [torch.empty_like(t) for t in src]
            torch._foreach_copy_(got, src)
            for i, t in zip(idx, got):
                fresh[i] = t
        out = []
        for how, k in self._plan:
            out.append(leaves[k] if how == "in" else out[k] if how == "same"
                       else fresh[k])
        return unflatten(self._out_spec, out)


def _by_dtype(tensors):
    """[(indices, tensors)] of ``tensors`` grouped by dtype."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return [(idx, [tensors[i] for i in idx]) for idx in groups.values()]
