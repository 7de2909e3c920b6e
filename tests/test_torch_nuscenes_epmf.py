"""EPMF-ResNet34 on nuScenes in the port against the benchmark's plain
reference (`benchmark/reference/nets.py: EPMFNet`, `view_v2_item.py`,
`view_cam.py`'s lift and merge), at small sizes on the CPU, each seeded: the
net with 17 classes in float32, the per-item V2 eval view bit for bit (the
items that face away from the ±45° crop included), the six-camera merge of
`NuscenesInference`'s EPMF branch exactly (ties included), the loop's
keyframe spans and its counters in a traced run, and the benchmark's FLOP
count against the port's.

They import neither JAX nor pmf_tpu.
"""
import copy
import json
import sys
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import inputs, keyframes  # noqa: E402
from benchmark.reference import flops, nets, view_cam, view_v2_item  # noqa: E402
from benchmark.reference.view import View  # noqa: E402
from pmf_tpu_torch.config import Options  # noqa: E402
from pmf_tpu_torch.data import V2Config, build_v2_eval_sample_with_uproj  # noqa: E402
from pmf_tpu_torch.models import EPMFNet  # noqa: E402
from pmf_tpu_torch.tools.infer_nuscenes import (N_CAMERAS, NuscenesInference,  # noqa: E402
                                                eval_view_config)
from pmf_tpu_torch.utils.flops import count_flops  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402, F401

SEED = 2**31 + 29
H, W, N, RETURNS, C = 64, 160, 2048, 1500, 17
MEAN, STDS = (12.87, 0.01, 0.44, 11.97, 19.07), (13.21, 6.05, 1.96, 12.5, 21.23)
# epmf_nuscenes.yaml's PVconfig group at the tests' size
PV = {"canvas_h": H, "canvas_w": W, "proj_h": H, "proj_w": W, "n_points": N,
      "pcd_mean": list(MEAN), "pcd_stds": list(STDS)}
REF_VIEW = View(canvas_h=H, canvas_w=W, proj_h=H, proj_w=W, img_mean=MEAN, img_stds=STDS)
ITEM_PARTS = ["pmf.keyframe.read", "pmf.keyframe.h2d", "pmf.view", "pmf.model",
              "pmf.keyframe.lift", "pmf.keyframe.readback", "pmf.keyframe.merge"]
EPMF_SPANS = ["pmf.k1", "pmf.model.lidar_stream.context", "pmf.model.camera_decoder.aspp",
              "pmf.model.camera_decoder.lidar_upsample"]


def pool(n_frames: int, seed: int = SEED) -> list[dict]:
    group = {"points": N, "returns": RETURNS, "image": [H, W]}
    return [it for kf in keyframes.pool(seed, n_frames, group, C) for it in kf]


def tensors(s: dict):
    t = lambda k: torch.as_tensor(s[k])
    return (t("points"), t("labels"), t("valid"), t("proj_matrix"), t("image"),
            int(s["img_h"]), int(s["img_w"]))


def options(**kw) -> Options:
    return Options(config={"PVconfig": PV}, dataset="nuScenes", nclasses=C,
                   net_type="EPMFNet", **kw)


def test_epmfnet_with_17_classes_matches_the_plain_reference():
    """The port's EPMFNet at the published widths (17 classes, base 32,
    ResNet34), float32, against the reference on the same seeded weights on
    a 64x160 view. Tolerance 1e-5 on probabilities, the benchmark's own
    test of the EPMF eval cell's net (the port folds each eval BN into its
    conv and sums in its own order)."""
    with torch.device("meta"):
        template = nets.EPMFNet(C, 32).state_dict()
    sd = inputs.weights(template, SEED, torch.device("cpu"))
    prog = EPMFNet(nclasses=C, base_channels=32, dtype=torch.float32)
    prog.load_state_dict(sd)
    ref = nets.EPMFNet(C, 32)
    ref.load_state_dict(sd)
    g = torch.Generator().manual_seed(SEED)
    pcd, img = torch.randn(1, H, W, 5, generator=g), torch.rand(1, H, W, 3, generator=g)
    with torch.no_grad():
        p, c = prog.eval()(pcd, img)
        rp, rc = ref.eval()(pcd, img)
    assert p.shape == (1, H, W, C) and c.shape == (1, H, W, C)
    assert (p - rp).abs().max() < 1e-5 and (c - rc).abs().max() < 1e-5
    # the classes depend on the input: the random weights are not flat
    assert p.argmax(-1).unique().numel() > 2


def test_the_loop_reads_the_v2_view_from_pvconfig():
    cfg = eval_view_config(options())
    assert isinstance(cfg, V2Config) and not cfg.cam_frame
    assert (cfg.canvas_h, cfg.proj_h, cfg.proj_w, cfg.n_points) == (H, H, W, N)
    assert (cfg.img_mean, cfg.img_stds) == (MEAN, STDS)
    assert (cfg.fov_left, cfg.fov_right) == (REF_VIEW.fov_left, REF_VIEW.fov_right)


def test_v2_item_view_equals_the_reference_bit_for_bit():
    """Each camera's item of two keyframes: features, mask, labels, the
    points' pixels, keep flags and depth. The crop is about the lidar's
    front whatever the camera: the front camera and the one facing back
    (the front's points mirrored through its image plane) keep points, the
    four that face sideways keep none."""
    cfg = eval_view_config(options())
    kept = []
    for s in pool(2):
        got = build_v2_eval_sample_with_uproj(*tensors(s), cfg)
        want = view_v2_item.v2_item(*tensors(s), REF_VIEW)
        assert len(got) == len(want) == 7
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        kept.append(int(want[5].sum()))
    for k in (0, 1):
        front, right, _, back, _, left = kept[k * N_CAMERAS:(k + 1) * N_CAMERAS]
        assert front > 0.05 * RETURNS and back > 0.05 * RETURNS
        assert right == left == 0
    assert kept.count(0) == 8


def stub_loop(items, tokens):
    """An EPMF NuscenesInference whose `item` gives the given (class,
    confidence) pairs, and the merged classes of each finished keyframe."""
    inf = NuscenesInference(options(), None,
                            lambda i: {"valid": np.ones(len(items[i][0]), bool),
                                       "labels": np.zeros(len(items[i][0]), np.int32)},
                            len(items), torch.device("cpu"), tokens)
    calls = iter(items)
    inf.item = lambda s: next(calls)
    merged = []
    inf._finish_frame = lambda token, pred, s: merged.append(pred.copy())
    return inf, merged


def test_merge_equals_the_reference_exactly_with_ties():
    """Two keyframes of six items with confidences on a coarse grid (ties
    between cameras, points no camera kept) and two items that keep
    nothing, through the EPMF branch's loop: the merge, and the counters
    of kept points and empty items."""
    rng = np.random.default_rng(SEED)
    n, items = 4096, []
    for i in range(2 * N_CAMERAS):
        kept = rng.random(n) < (0.0 if i in (2, 10) else 0.4)
        items.append((np.where(kept, rng.integers(1, C, n), 0).astype(np.int32),
                      np.where(kept, rng.integers(0, 4, n) / 4.0, -1.0).astype(np.float32)))
    inf, merged = stub_loop(items, ["a"] * 6 + ["b"] * 6)
    assert inf.is_v2 and inf.run()["frames"] == 2
    for k in range(2):
        frame = items[k * 6:(k + 1) * 6]
        assert np.array_equal(merged[k], view_cam.merge(frame))
        confs = np.stack([c for _, c in frame])
        assert ((confs == confs.max(0)).sum(0) > 1).any()    # the frame holds ties
    assert inf.kept_points == sum(int((c >= 0).sum()) for _, c in items)
    assert (inf.items, inf.empty_items) == (12, 2)


def small_loop(items, seed: int = 3):
    """The EPMF branch of NuscenesInference over `items` with a float32
    EPMFNet (17 classes, base 8) whose probabilities a forward hook keeps,
    and the merged classes of each keyframe."""
    from pmf_tpu_torch.models import build_model, random_weights

    opts = options(compute_dtype="float32", base_channels=8, img_backbone="resnet34")
    model = random_weights(build_model(opts), seed=seed).eval()
    probs = []
    model.register_forward_hook(lambda _m, _a, out: probs.append(out[0][0]))
    inf = NuscenesInference(opts, model, lambda i: items[i], len(items), torch.device("cpu"),
                            [f"kf{i // N_CAMERAS}" for i in range(len(items))])
    merged = []
    finish = inf._finish_frame

    def keep(token, pred, s):
        merged.append(pred.copy())
        return finish(token, pred, s)

    inf._finish_frame = keep
    return inf, probs, merged


def test_keyframe_spans_counters_and_merge_against_the_reference(tmp_path):
    """A traced run of two keyframes through the EPMF branch: each
    pmf.keyframe holds its six items' parts in order and one finish, and
    EPMF's own spans; the counters `kept_points` and `empty_items` equal
    what the reference view keeps; the merged classes equal the reference
    merge of the items' own probabilities lifted through the reference view."""
    items = pool(2, seed=SEED + 1)
    inf, probs, merged = small_loop(items)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = inf.run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    got = sorted((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") == "user_annotation" and e["name"].startswith("pmf."))
    frames = [s for s in got if s[0] == "pmf.keyframe"]
    assert out["frames"] == 2 and len(frames) == 2
    for _, a, b in frames:
        inner = [s[0] for s in sorted(got, key=lambda s: s[1])
                 if a <= s[1] and s[2] <= b and s[0] in ITEM_PARTS + ["pmf.keyframe.finish"]]
        assert inner == ITEM_PARTS * N_CAMERAS + ["pmf.keyframe.finish"]
        for name in EPMF_SPANS:
            assert sum(a <= s[1] and s[2] <= b for s in got if s[0] == name) == N_CAMERAS
    views = [view_v2_item.v2_item(*tensors(s), REF_VIEW) for s in items]
    keeps = [int(v[5].sum()) for v in views]
    assert (inf.items, inf.kept_points, inf.empty_items) == \
        (12, sum(keeps), keeps.count(0))
    assert 0 < inf.empty_items < 12
    assert len(probs) == 12
    for k in range(2):
        lifted = [view_cam.lift(p, *v[3:6])
                  for p, v in zip(probs[k * 6:(k + 1) * 6], views[k * 6:(k + 1) * 6])]
        assert np.array_equal(merged[k], view_cam.merge(lifted))
        assert (merged[k] > 0).any()


def test_benchmark_flop_count_equals_the_ports():
    """The benchmark's FLOPs of an EPMF nuScenes item (the reference on
    `meta` at 640x1280, 17 classes, base 32) equal the port's counter on its
    own EPMFNet's forward at that view."""
    want = flops.count("EPMFNet", 1, 640, 1280, C, 32, False)
    model = copy.deepcopy(EPMFNet(nclasses=C, base_channels=32)).to("meta").eval()
    with torch.no_grad():
        got = count_flops(model, torch.zeros(1, 640, 1280, 5, device="meta"),
                          torch.zeros(1, 640, 1280, 3, device="meta"))
    assert got == want
    assert 0.9e12 < want < 0.93e12
