"""CUDA graphs of the fusion nets' eval forward at batch 1.

At batch 1 a forward of PMFNet or EPMFNet issues about 600 launches, and
the card runs each faster than Python issues the next, so the per-scan and
per-item loops (tools/infer_kitti.py, infer_nuscenes.py, infer_a2d2.py)
wait on the host, not on the card. `GraphedNet`, the base of both nets,
captures such a forward as three CUDA graphs, one a stream, and replays
them: three launches a call.

A net gives its forward as the generator `streams`, which runs to a
`yield` after each of its three streams (the camera encoder with the
inputs' permutes and casts, the lidar stream, the camera decoder) and
yields the outputs at the last. `forward` runs it inside the span
pmf.model: eagerly, each stream inside its span, or through the graphs.

The gate (`GraphedNet.graphable`), all of it observable in the call: CUDA
inputs, eval mode, grad off, a batch of 1, no generator and no remat, no
row split and no process group; float32 and bf16 nets alike. A batch of 8
keeps the eager path: there the card's work outlasts the launches.
Training and the CPU keep it too.

Life cycle, by the inputs' signature (shapes, strides, dtypes, device and
whether inference mode is on): the first call runs eagerly. The second
warms up on a side stream (which fills `ops/aspp.py`'s plan cache and
cuDNN's choices), captures the three graphs into one memory pool, in order,
and replays them; later calls replay. Each replay copies the inputs into
the graphs' own and returns clones of their outputs, so no later call
writes into what a caller (or a forward hook) kept. `KEYS` signatures are
kept, the least recently used dropped first; `train()`, `to()` and the like
(`_apply`) and `load_state_dict` (so `models.load_weights` too) drop them
all, since parameters may be rebound.

Counters on the net classes: `graph_captures` (calls that captured) and
`graph_replays` (calls served by the graphs, the capturing call included).
A call through the graphs holds the span pmf.model.graphed around its
copies and replays; each replay sits inside its stream's span, so the
stream spans keep reading device time, while the spans nested inside the
streams occur in eager calls alone.
"""
from __future__ import annotations

from collections import OrderedDict

import torch
from torch import nn

from ..parallel import data_parallel, spatial
from ..utils.spans import span

STREAMS = ("pmf.model.camera_encoder", "pmf.model.lidar_stream", "pmf.model.camera_decoder")


class _Graphs:
    """One signature's graphs: the inputs they read, the three graphs and
    the outputs they write."""

    def __init__(self, net: GraphedNet, pcd: torch.Tensor, img: torch.Tensor):
        self.inputs = [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device)
                       for t in (pcd, img)]
        self.copy_in(pcd, img)
        device = pcd.device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in net.streams(*self.inputs):
                pass
        torch.cuda.current_stream(device).wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        self.graphs = []
        stages = net.streams(*self.inputs)
        with torch.cuda.device(device):
            for _ in STREAMS:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                    self.outputs = next(stages)
                self.graphs.append(graph)

    def copy_in(self, pcd: torch.Tensor, img: torch.Tensor) -> None:
        for static, t in zip(self.inputs, (pcd, img)):
            static.copy_(t)

    def __call__(self, pcd: torch.Tensor, img: torch.Tensor) -> tuple:
        with span("pmf.model.graphed"):
            self.copy_in(pcd, img)
            for name, graph in zip(STREAMS, self.graphs):
                with span(name):
                    graph.replay()
            return tuple(t.clone() for t in self.outputs)


class GraphedNet(nn.Module):
    """A fusion net whose eval forward at batch 1 runs through CUDA graphs
    (the module's docstring). Subclasses give `streams` and the counters."""

    KEYS = 4   # signatures kept

    def __init__(self):
        super().__init__()
        self._graphs: OrderedDict = OrderedDict()   # signature → None (seen once) or its graphs

    def streams(self, pcd_feature, img_feature, generator=None, remat: bool = False):
        """The forward as a generator: a `yield` after each stream, the
        outputs yielded at the last."""
        raise NotImplementedError

    def graphable(self, pcd_feature, img_feature, generator, remat: bool) -> bool:
        """Whether a call takes the graphs: CUDA inputs, eval mode, grad
        off, batch 1, no generator, no remat, no row split, no process
        group."""
        return (pcd_feature.is_cuda and img_feature.is_cuda and not self.training
                and not torch.is_grad_enabled() and pcd_feature.shape[0] == 1
                and generator is None and not remat and spatial.active() is None
                and not data_parallel())

    def forward(self, pcd_feature, img_feature, generator=None, remat: bool = False):
        """The span pmf.model, holding one span a stream
        (pmf.model.camera_encoder, .lidar_stream, .camera_decoder), through
        the graphs where `graphable` holds and the signature was seen."""
        with span("pmf.model"):
            if self.graphable(pcd_feature, img_feature, generator, remat):
                graphs = self._graphs_for(pcd_feature, img_feature)
                if graphs is not None:
                    type(self).graph_replays += 1
                    return graphs(pcd_feature, img_feature)
            stages = self.streams(pcd_feature, img_feature, generator, remat)
            for name in STREAMS:
                with span(name):
                    out = next(stages)
            return out

    def _graphs_for(self, pcd: torch.Tensor, img: torch.Tensor) -> _Graphs | None:
        """The signature's graphs, captured at its second call; None at its
        first."""
        key = tuple((t.shape, t.stride(), t.dtype, t.device) for t in (pcd, img)) + (
            torch.is_inference_mode_enabled(),)
        if key not in self._graphs:
            self._graphs[key] = None
            while len(self._graphs) > self.KEYS:
                self._graphs.popitem(last=False)
            return None
        self._graphs.move_to_end(key)
        if self._graphs[key] is None:
            self._graphs[key] = _Graphs(self, pcd, img)
            type(self).graph_captures += 1
        return self._graphs[key]

    def drop_graphs(self) -> None:
        """Forget every signature and its graphs."""
        self._graphs.clear()

    def train(self, mode: bool = True):
        if mode:
            self.drop_graphs()
        return super().train(mode)

    def _apply(self, fn, *args, **kwargs):
        self.drop_graphs()
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, state_dict, *args, **kwargs):
        self.drop_graphs()
        return super().load_state_dict(state_dict, *args, **kwargs)
