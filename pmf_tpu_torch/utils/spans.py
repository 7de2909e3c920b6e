"""Spans: named intervals around the port's layers, on torch.profiler's clock.

`span(name)` is `torch.profiler.record_function(name)` while a profiler is
active, and one shared null context otherwise, so a span costs one flag
read when nothing traces. The profiler keeps the spans beside the kernels
they launch (a Chrome trace's `user_annotation` events, whose launches'
`cuda_runtime` events carry the kernels' `args.correlation`) and writes
them out with its trace: the Trainer's `profile_dir`, or whatever profiler
the caller runs.

The port's spans are named `pmf.<layer>[.<part>]`. A span's children are
the spans inside its interval on its thread; the kernels a span launched
are those whose launch starts inside it, on any thread (backward launches
from autograd's). The tree:

    pmf.step                 train/steps.py: make_pmf_train_step's and
                             make_salsanext_train_step's step
      pmf.step.forward, pmf.step.loss,
      pmf.step.backward (holding pmf.step.allreduce), pmf.step.optimizer,
      pmf.step.confusion
    pmf.scan                 tools/infer_kitti.py: Inference.run, a scan
      pmf.scan.read, pmf.scan.h2d, pmf.view, pmf.model, pmf.scan.lift,
      pmf.scan.readback, pmf.scan.iou, pmf.scan.save
    pmf.keyframe             tools/infer_nuscenes.py: NuscenesInference.run,
                             a keyframe's six items and its finish
      per item: pmf.keyframe.read, pmf.keyframe.h2d, pmf.view, pmf.model,
      pmf.keyframe.lift, pmf.keyframe.readback, pmf.keyframe.merge;
      once: pmf.keyframe.finish
    pmf.view                 data/: the batched and per-scan views, the
                             range view's (data/range_pipeline.py) too
      pmf.k2                 ops/rasterize.py: rasterize_zbuffer
      pmf.k1                 ops/zbuffer.py: zbuffer_keys
    pmf.model                models/pmf.py, models/epmf.py: the fusion nets
      pmf.model.camera_encoder, pmf.model.lidar_stream (holding
      .context, .encoder, .fusion, .head, .decoder),
      pmf.model.camera_decoder (EPMF's holding .lidar_upsample, .aspp);
      models/salsanext.py: SalsaNext.forward, pmf.model.lidar_stream alone
      (holding .context, .encoder a resBlock, .head, .decoder; no .fusion);
      in a call that replays the nets' CUDA graphs (models/graphs.py)
      pmf.model.graphed holds the three stream spans, each around its
      graph's replay, and the spans nested in the streams do not occur
"""
from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks `name` in an active profiler's trace; nothing
    (one shared null context) while none is active."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
