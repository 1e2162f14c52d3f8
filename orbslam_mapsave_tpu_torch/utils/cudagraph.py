"""A body of device work replayed as one CUDA graph on the card: the one
place in the package that decides between a CUDA graph and eager code.
The port's hot stages are hundreds of small launches at static shapes,
which take the host far longer to launch than the card takes to run."""

from __future__ import annotations

from typing import Callable

import torch

from . import metrics


class Graph:
    """`fn()` as one `torch.cuda.CUDAGraph` on a CUDA device, eagerly elsewhere.

    `fn` takes no arguments and reads only static tensors that its owner
    allocated once on `device`; `into` holds static tensors that fn's
    outputs (a tuple as long) are copied into after each run.

    On a CUDA device the first call runs fn once on a side stream as a
    warm-up (a capture may not copy from the host, so constant tables must
    reach the device first; the warm-up writes nothing into `into`), then
    captures fn and the copies into `into` in one graph with a private
    memory pool and counts `<name>_captures`. Every call replays the graph,
    counts `<name>_replays` and returns the graph's static outputs, which
    the next call overwrites. A failed capture raises: there is no eager
    fallback on the card. On any other device a call runs fn, copies into
    `into` and returns fn's outputs, and counts nothing.
    """

    def __init__(self, name: str, device: torch.device, fn: Callable, into: tuple = ()):
        self.name = name
        self.device = torch.device(device)
        self.fn = fn
        self.into = into
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out = None

    def _run(self):
        out = self.fn()
        for dst, src in zip(self.into, out):
            dst.copy_(src)
        return out

    def __call__(self):
        if self.device.type != "cuda":
            return self._run()
        if self.graph is None:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self.fn()
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.out = self._run()
            self.graph = graph
            metrics.count(f"{self.name}_captures")
        self.graph.replay()
        metrics.count(f"{self.name}_replays")
        return self.out
