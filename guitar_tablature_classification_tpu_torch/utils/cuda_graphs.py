"""A module's forward replayed from CUDA graphs, one a batch shape, with the
kernel wrappers' launch counters kept true.

:class:`GraphedForward` takes the place of a module's ``forward`` (as
``torch.cuda.make_graphed_callables`` does), so ``module(x)`` still goes
through ``nn.Module.__call__``: its hooks fire once a call, with the
call's batch, and the module keeps its ``state_dict``.  A call replays a
graph only where :func:`engages` allows it: the input on a CUDA device,
the module in eval mode, grad off (``torch.inference_mode`` or
``no_grad``), and the batch one of the sizes given.
Every other call runs the module's own forward, as if no graph were there.

The first call of a shape runs the forward eagerly on a side stream (which
also makes the cuDNN plans, library handles and kernel builds the capture
needs), returns that result, and then captures the forward into a graph.
The graphs of all shapes share one memory pool: they replay one after
another on one stream.  The graph's input has the call's layout (a
broadcast dim stays broadcast), so the replay runs the kernels the eager
forward runs.  A later call copies its input into the graph's, replays it
and returns a copy of the graph's output, so the results of two calls
never alias.

The graphs read the module's parameters and buffers where they lie: a
weight changed in place (``load_state_dict``, an optimizer step) is what
the next replay reads.  A module moved or given new tensors (``.to()``,
``load_state_dict(assign=True)``) needs a new :class:`GraphedForward`.
Calls from several threads at once would share a graph's input and
output: one thread at a time.

**Launch counters.**  The kernel wrappers of ``ops/*_cuda.py`` count their
launches in Python (every module-level int, or dict of ints, with
``launches`` in its name), and a replay calls no wrapper.  A capture notes
how far each counter moved and puts it back (a capture launches nothing);
each replay adds what was noted.  After N calls each counter reads what N
eager forwards give (:func:`launch_counts`, :func:`launches_moved`,
:func:`add_launches`).

**Counters** (:mod:`.profiling`, while a recording is open):
``<prefix>.graph_captures``, ``<prefix>.graph_replays`` and
``<prefix>.eager_forwards``, the forwards on the card that replayed no
graph (a capturing call is one of them).
"""

from __future__ import annotations

import importlib
import pkgutil
import sys
import weakref
from typing import NamedTuple

import torch
from torch import nn

from . import profiling

# a launch counter: (module, its attribute, the dict's key or None for an int)
Counts = dict[tuple[str, str, "str | None"], int]


def _counter_modules() -> list:
    from .. import ops

    return [importlib.import_module(f"{ops.__name__}.{m.name}")
            for m in pkgutil.iter_modules(ops.__path__) if m.name.endswith("_cuda")]


def launch_counts() -> Counts:
    """Every launch counter of ``ops/*_cuda.py``: each module-level int whose
    name holds ``launches``, and each int of such a dict."""
    out: Counts = {}
    for mod in _counter_modules():
        for name, value in vars(mod).items():
            if "launches" not in name or isinstance(value, bool):
                continue
            if isinstance(value, int):
                out[(mod.__name__, name, None)] = value
            elif isinstance(value, dict):
                out.update(((mod.__name__, name, k), v) for k, v in value.items()
                           if isinstance(v, int) and not isinstance(v, bool))
    return out


def launches_moved(before: Counts, after: Counts) -> Counts:
    """The counters that moved from ``before`` to ``after``, by how much."""
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def add_launches(moved: Counts, times: int = 1) -> None:
    """Add ``times`` x ``moved`` to the counters."""
    for (mod, name, key), n in moved.items():
        module = sys.modules[mod]
        if key is None:
            setattr(module, name, getattr(module, name) + times * n)
        else:
            getattr(module, name)[key] += times * n


def engages(module: nn.Module, x: torch.Tensor, sizes) -> bool:
    """Whether ``module(x)`` may replay a graph: ``x`` on a CUDA device, the
    module in eval mode, grad off, and the batch one of ``sizes``."""
    return (x.is_cuda and not module.training and not torch.is_grad_enabled()
            and x.shape[0] in sizes)


def _read_part(x: torch.Tensor) -> torch.Tensor:
    """``x`` with each broadcast dim (stride 0) narrowed to one: the memory
    it reads (``tile_channels`` gives such an input)."""
    for d, (n, stride) in enumerate(zip(x.shape, x.stride())):
        if stride == 0 and n > 1:
            x = x.narrow(d, 0, 1)
    return x


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    src: torch.Tensor  # the memory of the input the graph reads, laid out as the call's
    out: torch.Tensor  # the output it writes
    launches: Counts  # what one forward adds to the launch counters


class GraphedForward:
    """``module.forward = GraphedForward(module, sizes, prefix)``: the
    module's forward, replayed from a CUDA graph for each input shape whose
    batch is one of ``sizes`` where :func:`engages` allows it, and its own
    forward otherwise.  ``prefix`` names the counters."""

    def __init__(self, module: nn.Module, sizes, prefix: str):
        self._module = weakref.ref(module)  # the module holds this object
        self._forward = type(module).forward
        self.sizes = frozenset(int(b) for b in sizes)
        self.graphs: dict[tuple, _Graph] = {}
        self._pool = None  # the memory pool the graphs share
        self._prefix = prefix
        self._captures = f"{prefix}.graph_captures"
        self._replays = f"{prefix}.graph_replays"
        self._eager = f"{prefix}.eager_forwards"

    def __reduce__(self):
        # a copy (copy.deepcopy, pickle) serves the copied module, with no graph
        return GraphedForward, (self._module(), sorted(self.sizes), self._prefix)

    def eager(self, *args, **kwargs):
        """The module's own forward, with no graph."""
        return self._forward(self._module(), *args, **kwargs)

    def __call__(self, x: torch.Tensor, *args, **kwargs):
        module = self._module()
        if args or kwargs or not engages(module, x, self.sizes):
            if x.is_cuda:
                profiling.count(self._eager)
            return self._forward(module, x, *args, **kwargs)
        key = (tuple(x.shape), x.stride(), x.dtype, x.device)
        g = self.graphs.get(key)
        if g is None:
            return self._capture(module, key, x)
        g.src.copy_(_read_part(x))
        g.graph.replay()
        add_launches(g.launches)
        profiling.count(self._replays)
        return g.out.clone()

    def _capture(self, module: nn.Module, key: tuple, x: torch.Tensor):
        """The first call of a shape: the forward eagerly on a side stream
        (its result is the call's), then the capture of the forward."""
        profiling.count(self._eager)
        profiling.count(self._captures)
        current = torch.cuda.current_stream(x.device)
        side = torch.cuda.Stream(x.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self._forward(module, x)
        current.wait_stream(side)
        out.record_stream(current)
        # the graph's input in the call's layout, broadcast dims and all: the
        # forward then takes the kernels it takes eagerly (a contiguous copy
        # of a broadcast input sends a convolution to another cuDNN kernel)
        src = _read_part(x)
        with torch.inference_mode(False):  # an input later calls may fill outside it too
            static_src = torch.empty_like(src)
        static_src.copy_(src)
        static_x = static_src.expand(x.shape)
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        try:
            with torch.cuda.device(x.device), torch.cuda.graph(
                    graph, pool=self._pool, stream=side):
                static_out = self._forward(module, static_x)
        finally:
            moved = launches_moved(before, launch_counts())
            add_launches(moved, -1)  # a capture launches nothing
        if self._pool is None:
            self._pool = graph.pool()
        self.graphs[key] = _Graph(graph, static_src, static_out, moved)
        return out
