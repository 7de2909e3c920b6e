"""PMF-ResNet50 on nuScenes in the port against the benchmark's plain
reference (`benchmark/reference/nets_r50.py`, `view_cam.py`), at small
sizes on the CPU, each seeded: the net in float32, the "cam" eval view bit
for bit, the six-camera merge of `NuscenesInference` exactly (ties
included), and the loop's keyframe spans and counters in a traced run.

They import neither JAX nor pmf_tpu.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import inputs, keyframes  # noqa: E402
from benchmark.reference import nets_r50, view_cam  # noqa: E402
from benchmark.reference.view import View  # noqa: E402
from pmf_tpu_torch.config import Options  # noqa: E402
from pmf_tpu_torch.data import PVConfig, build_eval_sample_with_uproj  # noqa: E402
from pmf_tpu_torch.models import PMFNet  # noqa: E402
from pmf_tpu_torch.tools.infer_nuscenes import N_CAMERAS, NuscenesInference  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402, F401

SEED = 2**31 + 17
H, W, N, RETURNS, C = 64, 160, 2048, 1500, 17
SENSOR = {"canvas_h": H, "canvas_w": W, "proj_h": H, "proj_w": W, "h_pad": 0, "w_pad": 0,
          "n_points": N}
ITEM_PARTS = ["pmf.keyframe.read", "pmf.keyframe.h2d", "pmf.view", "pmf.model",
              "pmf.keyframe.lift", "pmf.keyframe.readback", "pmf.keyframe.merge"]


def pool(n_frames: int, seed: int = SEED) -> list[dict]:
    group = {"points": N, "returns": RETURNS, "image": [H, W]}
    return [it for kf in keyframes.pool(seed, n_frames, group, C) for it in kf]


def weights(seed: int = SEED) -> dict:
    with torch.device("meta"):
        template = nets_r50.PMFNetR50(C, 32).state_dict()
    return inputs.weights(template, seed, torch.device("cpu"))


def tensors(s: dict):
    t = lambda k: torch.as_tensor(s[k])
    return (t("points"), t("labels"), t("valid"), t("proj_matrix"), t("image"),
            int(s["img_h"]), int(s["img_w"]))


def test_pmfnet_resnet50_matches_the_plain_reference():
    """The port's PMFNet(image_backbone="resnet50") at the published widths
    (17 classes, base 32), float32, against the reference's unfolded BN on
    a 64x160 view. Tolerance 5e-6 on probabilities: the port folds each
    eval BN into its conv (w·a, b − mean·a) and sums in its own order,
    which 53 folded convs deep moves float32's last bits (up to 4.6e-7 on
    three seeds); 5e-6 leaves room for other CPUs' summation orders."""
    sd = weights()
    prog = PMFNet(nclasses=C, base_channels=32, image_backbone="resnet50",
                  dtype=torch.float32)
    prog.load_state_dict(sd)
    ref = nets_r50.PMFNetR50(C, 32)
    ref.load_state_dict(sd)
    g = torch.Generator().manual_seed(SEED)
    pcd, img = torch.randn(1, H, W, 5, generator=g), torch.rand(1, H, W, 3, generator=g)
    with torch.no_grad():
        p, c = prog.eval()(pcd, img)
        rp, rc = ref.eval()(pcd, img)
    assert p.shape == (1, H, W, C) and c.shape == (1, H, W, C)
    assert (p - rp).abs().max() < 5e-6 and (c - rc).abs().max() < 5e-6
    # the classes depend on the input: the random weights are not flat
    assert p.argmax(-1).unique().numel() > 2


def test_resnet50_encoder_widths_and_flops():
    enc = nets_r50.ResNet50()
    feats = enc(torch.zeros(1, 3, 32, 64))
    assert [f.shape[1] for f in feats] == [256, 512, 1024, 2048]
    assert [f.shape[2] for f in feats] == [16, 8, 4, 2]
    # the FLOP count grows with the view and the backbone
    r50 = nets_r50.count(1, 64, 160, C, 32, train=False)
    assert r50 > 0 and nets_r50.count(1, 128, 160, C, 32, train=False) > 1.9 * r50


def test_cam_view_equals_the_reference_bit_for_bit():
    """Each camera's item of two keyframes: features, mask, labels, the
    points' pixels and keep flags."""
    cfg = PVConfig(projection="cam", **SENSOR)
    rv = View.from_dict(SENSOR)
    kept = []
    for s in pool(2):
        got = build_eval_sample_with_uproj(*tensors(s), cfg)
        want = view_cam.cam_item(*tensors(s), rv)
        for a, b in zip(got[:6], want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        kept.append(int(want[5].sum()))
    # each camera keeps some of the sweep, and none keeps most of it
    assert min(kept) > 0.02 * RETURNS and max(kept) < 0.5 * RETURNS


def stub_loop(items, tokens):
    """A NuscenesInference whose `item` gives the given (class, confidence)
    pairs, and the merged classes of each finished keyframe."""
    opts = Options(config={"sensor": SENSOR}, dataset="nuScenes", nclasses=C)
    inf = NuscenesInference(opts, None, lambda i: {"valid": np.ones(len(items[i][0]), bool),
                                                   "labels": np.zeros(len(items[i][0]),
                                                                      np.int32)},
                            len(items), torch.device("cpu"), tokens)
    calls = iter(items)
    inf.item = lambda s: next(calls)
    merged = []
    inf._finish_frame = lambda token, pred, s: merged.append(pred.copy())
    return inf, merged


def test_merge_equals_the_reference_exactly_with_ties():
    """Two keyframes of six items with confidences on a coarse grid (many
    ties between cameras, and points no camera kept), and a third keyframe
    cut short, which is not finished."""
    rng = np.random.default_rng(SEED)
    n, items = 4096, []
    for _ in range(2 * N_CAMERAS + 3):
        kept = rng.random(n) < 0.4
        items.append((np.where(kept, rng.integers(1, C, n), 0).astype(np.int32),
                      np.where(kept, rng.integers(0, 4, n) / 4.0, -1.0).astype(np.float32)))
    tokens = ["a"] * 6 + ["b"] * 6 + ["c"] * 3
    inf, merged = stub_loop(items, tokens)
    out = inf.run()
    assert out["frames"] == 2 and len(merged) == 2
    assert (inf.items, inf.frames) == (15, 2)
    contested = 0
    for k in range(2):
        frame = items[k * 6:(k + 1) * 6]
        want = view_cam.merge(frame)
        assert np.array_equal(merged[k], want)
        confs = np.stack([c for _, c in frame])
        assert ((confs == confs.max(0)).sum(0) > 1).any()    # the frame holds ties
        contested += int((np.sum([c >= 0 for _, c in frame], axis=0) > 1).sum())
    assert inf.contested == contested
    # ties keep the earlier camera: the merge is not the later camera's
    a, b = (np.array([3, 5], np.int32), np.array([0.5, 0.25], np.float32)), \
        (np.array([7, 9], np.int32), np.array([0.5, 0.75], np.float32))
    inf, merged = stub_loop([a, b, a, a, a, a], ["x"] * 6)
    inf.run()
    assert merged[0].tolist() == view_cam.merge([a, b, a, a, a, a]).tolist() == [3, 9]


def test_keyframe_spans_and_counters(tmp_path):
    """A traced run of two keyframes: each pmf.keyframe holds its six items'
    parts in order and one finish; the counters count items, keyframes and
    the points more than one camera kept (against the reference view)."""
    items = pool(2)
    opts = Options(config={"sensor": SENSOR}, dataset="nuScenes", nclasses=C,
                   net_type="PMFNet", compute_dtype="float32", base_channels=8,
                   img_backbone="resnet50")
    from pmf_tpu_torch.models import build_model, random_weights

    model = random_weights(build_model(opts), seed=3).eval()
    inf = NuscenesInference(opts, model, lambda i: items[i], len(items), torch.device("cpu"),
                            [f"kf{i // N_CAMERAS}" for i in range(len(items))])
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
    rv = View.from_dict(SENSOR)
    contested = 0
    for k in range(2):
        keep = [view_cam.cam_item(*tensors(s), rv)[5].numpy()
                for s in items[k * 6:(k + 1) * 6]]
        contested += int((np.sum(keep, axis=0) > 1).sum())
    assert (inf.items, inf.frames, inf.contested) == (12, 2, contested)
    assert contested > 0
