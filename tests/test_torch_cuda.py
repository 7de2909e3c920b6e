"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and skip without one. They import neither
JAX nor pmf_tpu, so they also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from pmf_tpu_torch.ops import rasterize as trast
from pmf_tpu_torch.ops import zbuffer as tzbuf
from pmf_tpu_torch.ops.scatter import packed_keys

IMAX = 2**31 - 1


def points_with_ties(seed, B, N, H, W, F=6):
    """Random points with forced ties: points copied onto other points'
    pixel and depth (equal dq at different indices), points not kept, and
    rows/cols outside the image (clamped onto the border)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, H, (B, N)).astype(np.int32)
    cols = rng.integers(0, W, (B, N)).astype(np.int32)
    depth = rng.uniform(1, 80, (B, N)).astype(np.float32)
    src = rng.integers(0, N, (B, N // 10))
    dst = rng.integers(0, N, (B, N // 10))
    for b in range(B):
        rows[b, dst[b]] = rows[b, src[b]]
        cols[b, dst[b]] = cols[b, src[b]]
        depth[b, dst[b]] = depth[b, src[b]]
    depth[:, :50] = np.floor(depth[:, :50] * 64) / 64          # on a quantum edge
    rows[:, 50:60] = H + 3
    cols[:, 60:70] = -5
    keep = rng.random((B, N)) > 0.2
    vals = rng.normal(size=(B, N, F)).astype(np.float32)
    vals[..., 5] = rng.integers(0, 20, (B, N))
    return rows, cols, depth, keep, vals


def crowded_points(seed, B, N, H, W, F=6, side=2):
    """`points_with_ties`, but every point on a side x side square of pixels
    at 4 depth quanta: heavy contention, and ties at equal dq."""
    rows, cols, depth, keep, vals = points_with_ties(seed, B, N, H, W, F)
    rng = np.random.default_rng(seed + 1)
    rows = (H // 2 + rng.integers(0, side, (B, N))).astype(np.int32)
    cols = (W // 2 + rng.integers(0, side, (B, N))).astype(np.int32)
    depth = (rng.integers(64, 68, (B, N)) / 64 + rng.uniform(0, 1 / 64, (B, N))).astype(np.float32)
    return rows, cols, depth, keep, vals


def points_case(case, seed, B, N, H, W):
    """The points of a named case: "ties" (`points_with_ties`), "crowded"
    (`crowded_points`) or "dropped" (`points_with_ties` with no point kept)."""
    if case == "crowded":
        return crowded_points(seed, B, N, H, W)
    rows, cols, depth, keep, vals = points_with_ties(seed, B, N, H, W)
    if case == "dropped":
        keep[:] = False
    return rows, cols, depth, keep, vals


def pix_keys_with_ties(seed, B, N, H, W):
    rng = np.random.default_rng(seed)
    pix = rng.integers(0, H * W + 1, (B, N)).astype(np.int32)   # incl. sentinel
    key = rng.integers(0, 1 << 30, (B, N)).astype(np.int32)
    key[:, : N // 10] = key[:, N // 10: 2 * (N // 10)]           # equal keys ...
    pix[:, : N // 10] = pix[:, N // 10: 2 * (N // 10)]           # ... on one pixel
    key[pix == H * W] = IMAX
    return pix, key


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_zbuffer_keys_kernel_matches_plain(cuda_device):
    B, N, H, W = 8, 32768, 384, 1232
    pix, key = (torch.from_numpy(a).to(cuda_device) for a in pix_keys_with_ties(4, B, N, H, W))
    before = tzbuf.zbuffer_keys.launches
    got = tzbuf.zbuffer_keys(pix, key, H, W)
    torch.cuda.synchronize()
    assert tzbuf.zbuffer_keys.launches == before + 1
    assert torch.equal(got, tzbuf.zbuffer_keys_plain(pix, key, H, W))


@pytest.mark.cuda
def test_rasterize_kernel_matches_plain(cuda_device):
    B, N, H, W = 8, 32768, 384, 1232
    args = [torch.from_numpy(a).to(cuda_device) for a in points_with_ties(5, B, N, H, W)]
    before = trast.rasterize_zbuffer.launches
    canvas, mask = trast.rasterize_zbuffer(*args, H, W)
    torch.cuda.synchronize()
    assert trast.rasterize_zbuffer.launches == before + 1
    want_c, want_m = trast.rasterize_zbuffer_plain(*args, H, W)
    assert torch.equal(mask, want_m) and torch.equal(canvas, want_c)


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs(cuda_device):
    rows, cols, depth, keep, vals = (torch.from_numpy(a).to(cuda_device)
                                     for a in points_with_ties(6, 2, 100, 8, 8))
    with pytest.raises(ValueError):
        trast.rasterize_zbuffer(rows.long(), cols, depth, keep, vals, 8, 8)
    with pytest.raises(ValueError):
        trast.rasterize_zbuffer(rows, cols, depth, keep, vals.transpose(0, 1), 8, 8)
    with pytest.raises(ValueError):
        tzbuf.zbuffer_keys(rows, cols.cpu(), 8, 8)


# N = 65535 is the most points a scan with 32-bit keys, 65536 the fewest with
# 64-bit keys; 131072 is PVConfig's default buffer
@pytest.mark.cuda
@pytest.mark.parametrize("case,B,N", [("ties", 1, 131072), ("ties", 2, 65535),
                                      ("ties", 2, 65536), ("crowded", 2, 32768),
                                      ("dropped", 2, 32768)])
def test_rasterize_kernel_cases_match_plain(cuda_device, case, B, N):
    H, W = 384, 1232
    args = [torch.from_numpy(a).to(cuda_device) for a in points_case(case, 7, B, N, H, W)]
    canvas, mask = trast.rasterize_zbuffer(*args, H, W)
    torch.cuda.synchronize()
    want_c, want_m = trast.rasterize_zbuffer_plain(*args, H, W)
    assert torch.equal(mask, want_m) and torch.equal(canvas, want_c)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["crowded", "dropped"])
def test_zbuffer_keys_kernel_cases_match_plain(cuda_device, case):
    B, N, H, W = 2, 32768, 384, 1232
    rows, cols, depth, keep, _ = (torch.from_numpy(a).to(cuda_device)
                                  for a in points_case(case, 8, B, N, H, W))
    pix, key, _ = packed_keys(rows, cols, depth, keep, H, W, 1 / 64)
    got = tzbuf.zbuffer_keys(pix, key, H, W)
    torch.cuda.synchronize()
    assert torch.equal(got, tzbuf.zbuffer_keys_plain(pix, key, H, W))


@pytest.mark.cuda
def test_kernels_replay_in_cuda_graph(cuda_device):
    """Both wrappers captured into one CUDA graph: a replay on new points
    copied into the captured inputs gives what an eager call gives."""
    B, N, H, W = 2, 4096, 64, 200
    first, second = ([torch.from_numpy(a).to(cuda_device) for a in points_with_ties(s, B, N, H, W)]
                     for s in (9, 10))
    inputs = [t.clone() for t in first]

    def both():
        canvas, mask = trast.rasterize_zbuffer(*inputs, H, W)
        pix, key, _ = packed_keys(*inputs[:4], H, W, 1 / 64)
        return canvas, mask, tzbuf.zbuffer_keys(pix, key, H, W)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = both()
    for points in (second, first):
        for t, p in zip(inputs, points):
            t.copy_(p)
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        eager = both()
        assert all(torch.equal(o, e) for o, e in zip(outs, eager))


def _train_cfg(h, w, th, tw, n):
    from pmf_tpu_torch.data import PVConfig

    return PVConfig(canvas_h=h, canvas_w=w + 16, proj_h=h, proj_w=w, proj_ht=th, proj_wt=tw,
                    h_pad=2, w_pad=2, n_points=n, img_jitter=(0.4, 0.4, 0.4))


@pytest.mark.cuda
def test_train_view_kernels_match_plain(cuda_device):
    """The train view with return_points through K2 and K1 equals the same
    view with the plain fills, with the augmentation drawn from a CUDA
    generator (both calls from the same seed)."""
    from pmf_tpu_torch.data import build_batch
    from pmf_tpu_torch.data.perspective_pipeline import _build_batch
    from pmf_tpu_torch.data.synthetic import make_inputs

    B, N, H, W = 4, 16384, 128, 416
    cfg = _train_cfg(H, W, 96, 320, N)
    batch = [torch.from_numpy(a).to(cuda_device) for a in make_inputs(np.random.default_rng(11), B, N, H, W)]
    gen = lambda: torch.Generator(device=cuda_device).manual_seed(12)
    before = (trast.rasterize_zbuffer.launches, tzbuf.zbuffer_keys.launches)
    got = build_batch(*batch, cfg, train=True, generator=gen(), return_points=True)
    torch.cuda.synchronize()
    assert (trast.rasterize_zbuffer.launches, tzbuf.zbuffer_keys.launches) == \
        (before[0] + 1, before[1] + 1)
    want = _build_batch(*batch, cfg, True, gen(), None, True,
                        fill=trast.rasterize_zbuffer_plain, keys=tzbuf.zbuffer_keys_plain)
    for a, b in zip((*got[:3], *got[3]), (*want[:3], *want[3])):
        assert torch.equal(a, b)
    assert got[1].sum() > 1000


@pytest.mark.cuda
def test_bf16_train_step_small(cuda_device):
    """One bf16 train step of a small PMFNet on the card: finite losses,
    most parameters moved, confusion matrices over every pixel, both kernels
    launched by the view."""
    from pmf_tpu_torch.data import build_batch
    from pmf_tpu_torch.data.synthetic import make_inputs
    from pmf_tpu_torch.models import PMFNet, random_weights
    from pmf_tpu_torch.train import HybridOptimizer, LossConfig, make_pmf_train_step

    B, N, H, W = 2, 4096, 64, 160
    cfg = _train_cfg(H, W, 48, 96, N)
    batch = [torch.from_numpy(a).to(cuda_device) for a in make_inputs(np.random.default_rng(13), B, N, H, W)]
    g = torch.Generator(device=cuda_device).manual_seed(14)
    model = random_weights(PMFNet(nclasses=20, base_channels=8, dtype=torch.bfloat16), seed=15)
    model = model.to(cuda_device)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    step = make_pmf_train_step(model, HybridOptimizer(model, lambda s: 1e-3, 0.9, 1e-5),
                               LossConfig(alpha=tuple([0.0] + [1.0] * 19)))
    launches = (trast.rasterize_zbuffer.launches, tzbuf.zbuffer_keys.launches)
    f, _, label, points = build_batch(*batch, cfg, train=True, generator=g, return_points=True)
    aux = step(f, label, g, points)
    torch.cuda.synchronize()
    assert trast.rasterize_zbuffer.launches > launches[0]
    assert tzbuf.zbuffer_keys.launches > launches[1]
    assert all(torch.isfinite(v).all() for v in aux.values())
    assert aux["conf"].sum() == aux["conf_cam"].sum() == B * 48 * 96
    moved = [not torch.equal(before[k], p) for k, p in model.named_parameters()]
    assert sum(moved) > len(moved) // 2


def _epmf_cfg(n):
    from pmf_tpu_torch.data import V2Config

    return V2Config(canvas_h=384, canvas_w=1248, proj_h=320, proj_w=1280, proj_ht=320,
                    proj_wt=1280, n_points=n)


@pytest.mark.cuda
def test_v2_batch_kernels_match_plain_at_131072_points(cuda_device):
    """The EPMF view (eval, and train with return_points from a CUDA
    generator) at the shipped config's 131072 points a scan: K2 on its
    64-bit keys and K1 with 17 index bits, equal to the plain fills."""
    from pmf_tpu_torch.data import build_v2_batch
    from pmf_tpu_torch.data.perspective_pipeline_v2 import _build_v2_batch
    from pmf_tpu_torch.data.synthetic import make_inputs

    B, N = 2, 131072
    cfg = _epmf_cfg(N)
    batch = [torch.from_numpy(a).to(cuda_device)
             for a in make_inputs(np.random.default_rng(16), B, N, 384, 1232)]
    for train in (False, True):
        gen = lambda: torch.Generator(device=cuda_device).manual_seed(17)
        before = (trast.rasterize_zbuffer.launches, tzbuf.zbuffer_keys.launches)
        got = build_v2_batch(*batch, cfg, train, gen(), return_points=True)
        torch.cuda.synchronize()
        assert (trast.rasterize_zbuffer.launches, tzbuf.zbuffer_keys.launches) == \
            (before[0] + 1, before[1] + 1)
        want = _build_v2_batch(*batch, cfg, train, gen(), None, True,
                               fill=trast.rasterize_zbuffer_plain, keys=tzbuf.zbuffer_keys_plain)
        for a, b in zip((*got[:3], *got[3]), (*want[:3], *want[3])):
            assert torch.equal(a, b)
        assert got[1].sum() > 10000


@pytest.mark.cuda
def test_epmf_per_scan_path_replays_in_cuda_graph(cuda_device):
    """The EPMF per-scan eval view (K1 and a gather) captured into a CUDA
    graph: a replay on another scan copied into the captured inputs gives
    what an eager call gives."""
    from pmf_tpu_torch.data import build_v2_eval_sample_with_uproj
    from pmf_tpu_torch.data.synthetic import make_inputs

    N = 131072
    cfg = _epmf_cfg(N)
    scans = [[torch.as_tensor(a[0]).to(cuda_device)
              for a in make_inputs(np.random.default_rng(s), 1, N, 384, 1232)] for s in (18, 19)]
    inputs = [t.clone() for t in scans[0]]
    view = lambda: build_v2_eval_sample_with_uproj(*inputs, cfg)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        view()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = tzbuf.zbuffer_keys.launches
    with torch.cuda.graph(graph):
        outs = view()
    assert tzbuf.zbuffer_keys.launches == before + 1
    for scan in (scans[1], scans[0]):
        for t, s in zip(inputs, scan):
            t.copy_(s)
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        eager = view()
        assert all(torch.equal(o, e) for o, e in zip(outs, eager))
        assert outs[1].sum() > 10000


@pytest.mark.cuda
def test_zbuffer_keys_kernel_at_the_range_batch(cuda_device):
    """K1 at the SalsaNext range batch (8 scans of 131072 points, 17 index
    bits, into 64x2048) with forced ties equals its plain version, eagerly
    and replayed in a CUDA graph on another batch copied into its inputs."""
    B, N, H, W = 8, 131072, 64, 2048
    first, second = ([torch.from_numpy(a).to(cuda_device) for a in pix_keys_with_ties(s, B, N, H, W)]
                     for s in (20, 21))
    pix, key = (t.clone() for t in first)
    before = tzbuf.zbuffer_keys.launches
    got = tzbuf.zbuffer_keys(pix, key, H, W)
    torch.cuda.synchronize()
    assert tzbuf.zbuffer_keys.launches == before + 1
    assert torch.equal(got, tzbuf.zbuffer_keys_plain(pix, key, H, W))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tzbuf.zbuffer_keys(pix, key, H, W)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tzbuf.zbuffer_keys(pix, key, H, W)
    for p, k in (second, first):
        pix.copy_(p)
        key.copy_(k)
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, tzbuf.zbuffer_keys_plain(p, k, H, W))


@pytest.mark.cuda
def test_range_batch_kernel_fill_matches_plain(cuda_device):
    """`build_range_batch` (eval, and train with the point augmentation
    drawn from a CUDA generator) at 8 scans of 131072 points into 64x2048:
    one K1 launch, and the features, labels and mask of the plain fill."""
    from pmf_tpu_torch.data import AugmentConfig, RangeConfig, build_range_batch
    from pmf_tpu_torch.data.range_pipeline import _build_range_batch
    from pmf_tpu_torch.data.synthetic import make_range_inputs

    B, N = 8, 131072
    aug = AugmentConfig(p_flipy=0.5, p_transx=0.5, trans_xmin=-5, trans_xmax=5, p_rot_yaw=0.5,
                        rot_yawmin=5, rot_yawmax=-5, p_rot_roll=0.5, rot_rollmin=-5,
                        rot_rollmax=5)
    cfg = RangeConfig(n_points=N, augment=aug)
    batch = [torch.from_numpy(a).to(cuda_device)
             for a in make_range_inputs(np.random.default_rng(22), B, N, N - 8000)]
    for train in (False, True):
        gen = lambda: torch.Generator(device=cuda_device).manual_seed(23)
        before = tzbuf.zbuffer_keys.launches
        got = build_range_batch(*batch, cfg, train, gen())
        torch.cuda.synchronize()
        assert tzbuf.zbuffer_keys.launches == before + 1
        want = _build_range_batch(*batch, cfg, train, gen(), keys=tzbuf.zbuffer_keys_plain)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert got[0].shape == (B, 64, 2048, 5) and got[2].sum() > B * 50000


@pytest.mark.cuda
def test_nuscenes_kernels_match_plain(cuda_device):
    """The nuScenes shapes (pmf_nuscenes.yaml): K1 on one eval item, 65536
    points into 896x1600 (16 index bits, depth clipped at 512 m), and K2 at
    the PMF train batch, 3 x 65536 points into 640x960 (64-bit keys), with
    forced ties, equal to their plain versions."""
    N = 65536
    rows, cols, depth, keep, vals = (torch.from_numpy(a).to(cuda_device)
                                     for a in points_with_ties(24, 1, N, 896, 1600))
    depth[:, 100:200] = 600.0                                    # past the clip
    pix, key, nbits = packed_keys(rows, cols, depth, keep, 896, 1600, 1 / 64)
    assert nbits == 16
    before = tzbuf.zbuffer_keys.launches
    got = tzbuf.zbuffer_keys(pix, key, 896, 1600)
    torch.cuda.synchronize()
    assert tzbuf.zbuffer_keys.launches == before + 1
    assert torch.equal(got, tzbuf.zbuffer_keys_plain(pix, key, 896, 1600))

    args = [torch.from_numpy(a).to(cuda_device) for a in points_with_ties(25, 3, N, 640, 960)]
    before = trast.rasterize_zbuffer.launches
    canvas, mask = trast.rasterize_zbuffer(*args, 640, 960)
    torch.cuda.synchronize()
    assert trast.rasterize_zbuffer.launches == before + 1
    want_c, want_m = trast.rasterize_zbuffer_plain(*args, 640, 960)
    assert torch.equal(mask, want_m) and torch.equal(canvas, want_c)


@pytest.mark.cuda
def test_nuscenes_cam_view_kernels_match_plain(cuda_device):
    """PMF's "cam" view of synthetic nuScenes keyframes on the card: the
    per-item eval view through K1 and the train view with the points'
    winner flags through K2 and K1 equal the same with the plain versions;
    the winners of the flags are K2's mask (depths stay within K1's 512 m
    clip)."""
    from pmf_tpu_torch.data import AugParams, PVConfig, build_batch, build_eval_sample_with_uproj
    from pmf_tpu_torch.data.perspective_pipeline import _build_batch
    from pmf_tpu_torch.data.synthetic import make_nuscenes_inputs

    raw = make_nuscenes_inputs(np.random.default_rng(26), 1)
    batch = [torch.from_numpy(a).to(cuda_device) for a in raw]
    cfg = PVConfig(canvas_h=900, canvas_w=1600, proj_h=896, proj_w=1600, proj_ht=640,
                   proj_wt=960, h_pad=0, w_pad=0, n_points=65536, projection="cam")
    one = [t[0] for t in batch]
    got = build_eval_sample_with_uproj(*one[:5], 900, 1600, cfg)
    assert got[1].sum() > 3000
    aug = AugParams(*(torch.tensor(v, device=cuda_device)[:3].expand(3) for v in
                      ([True], [0.1], [100], [300])))
    f, m, lab, (pix, plab, won) = build_batch(*(t[:3] for t in batch), cfg, True,
                                              aug_override=aug, return_points=True)
    want = _build_batch(*(t[:3] for t in batch), cfg, True, None, aug, True,
                        fill=trast.rasterize_zbuffer_plain, keys=tzbuf.zbuffer_keys_plain)
    assert all(torch.equal(a, b) for a, b in zip((f, m, lab, pix, plab, won),
                                                 (*want[:3], *want[3])))
    hw = 640 * 960
    win_pix = torch.where(won, pix.long(), hw)
    hit = torch.zeros((3, hw + 1), dtype=torch.bool, device=cuda_device).scatter_(1, win_pix, True)
    assert torch.equal(hit[:, :hw].view_as(m), m) and m.sum() > 3000
    lab_at = torch.cat([lab.view(3, -1), torch.zeros_like(lab.view(3, -1)[:, :1])], 1)
    assert torch.equal(lab_at.gather(1, win_pix)[won], plab[won])


@pytest.mark.cuda
def test_a2d2_kernels_match_plain(cuda_device):
    """The A2D2 shapes (epmf_a2d2.yaml): K2 at the train view's batch, 6 x
    32768 points into 320x960 (32-bit keys), and K1 on one eval scan, 32768
    points into 480x1280 (15 index bits), with forced ties, equal to their
    plain versions."""
    N = 32768
    args = [torch.from_numpy(a).to(cuda_device) for a in points_with_ties(27, 6, N, 320, 960)]
    before = trast.rasterize_zbuffer.launches
    canvas, mask = trast.rasterize_zbuffer(*args, 320, 960)
    torch.cuda.synchronize()
    assert trast.rasterize_zbuffer.launches == before + 1
    want_c, want_m = trast.rasterize_zbuffer_plain(*args, 320, 960)
    assert torch.equal(mask, want_m) and torch.equal(canvas, want_c)

    rows, cols, depth, keep, _ = (torch.from_numpy(a).to(cuda_device)
                                  for a in points_with_ties(28, 1, N, 480, 1280))
    pix, key, nbits = packed_keys(rows, cols, depth, keep, 480, 1280, 1 / 64)
    assert nbits == 15
    before = tzbuf.zbuffer_keys.launches
    got = tzbuf.zbuffer_keys(pix, key, 480, 1280)
    torch.cuda.synchronize()
    assert tzbuf.zbuffer_keys.launches == before + 1
    assert torch.equal(got, tzbuf.zbuffer_keys_plain(pix, key, 480, 1280))


@pytest.mark.cuda
def test_a2d2_pix_view_kernel_matches_plain(cuda_device):
    """The V2 view on A2D2's stored pixels (build_v2_batch_pix) at the
    validation batch, 10 synthetic scans into 480x1280, and at the train
    view's 320x960 with the winner flags: K2 and K1 equal the plain fills."""
    from pmf_tpu_torch.data import V2Config, build_v2_batch_pix
    from pmf_tpu_torch.data.perspective_pipeline_v2 import _build_v2_batch
    from pmf_tpu_torch.data.synthetic import make_a2d2_inputs

    raw = make_a2d2_inputs(np.random.default_rng(29), 10)
    batch = [torch.from_numpy(a).to(cuda_device) for a in raw]
    cfg = V2Config(canvas_h=1208, canvas_w=1920, proj_h=480, proj_w=1280, proj_ht=320,
                   proj_wt=960, n_points=32768)
    for train, b, points in ((False, 10, False), (True, 6, True)):
        gen = lambda: torch.Generator(device=cuda_device).manual_seed(3)
        one = [t[:b] for t in batch]
        got = build_v2_batch_pix(*one, cfg, train, gen(), return_points=points)
        want = _build_v2_batch(*one[:3], None, *one[5:], cfg, train, gen(), None, points,
                               fill=trast.rasterize_zbuffer_plain, keys=tzbuf.zbuffer_keys_plain,
                               pix=(one[3], one[4]))
        assert all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
        if points:
            assert all(torch.equal(a, b) for a, b in zip(got[3], want[3]))
        assert got[1].sum() > b * 3000


@pytest.mark.cuda
def test_sensat_batch_card_matches_cpu(cuda_device):
    """build_sensat_batch (no kernel) on the card against the CPU with the
    same draws, their rotations quarter turns: the redraw selection and the
    crops bit for bit. (A quarter turn maps the crop's cells near integer
    source coordinates, so a last-place difference between the devices'
    cos and sin cannot move a cell; at other angles a source within an ulp
    of a half pixel could round either way.)"""
    from pmf_tpu_torch.data import SensatConfig, build_sensat_batch
    from pmf_tpu_torch.data.sensat_urban import draw_sensat_aug

    rng = np.random.default_rng(30)
    fm = rng.random((4, 8, 640, 640)).astype(np.float32)
    fm[:, 4] = rng.random((4, 640, 640)) < 0.4
    lm = np.where(fm[:, 4] > 0, rng.integers(0, 13, (4, 640, 640)), -1).astype(np.float32)
    cfg = SensatConfig(min_valid=0.4)
    aug = draw_sensat_aug(torch.Generator().manual_seed(1), 4, 640, 640, cfg)
    aug = aug._replace(theta=torch.randint(-1, 3, aug.theta.shape).float() * (np.pi / 2))
    cpu = build_sensat_batch(torch.from_numpy(fm), torch.from_numpy(lm), cfg, True,
                             aug_override=aug)
    card = build_sensat_batch(torch.from_numpy(fm).to(cuda_device),
                              torch.from_numpy(lm).to(cuda_device), cfg, True,
                              aug_override=type(aug)(*(t.to(cuda_device) for t in aug)))
    assert all(torch.equal(a, b.cpu()) for a, b in zip(cpu, card))


# (N, C, H, W): EPMF's camera-decoder ASPP, PMF's lidar head at batch 8 and one
# scan, EPMF's lidar head
ASPP_SHAPES = {"epmf_camera": (8, 512, 20, 80), "pmf_head": (8, 256, 24, 77),
               "epmf_head": (8, 256, 10, 40), "pmf_head_scan": (1, 256, 24, 77)}


def bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(v)) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ASPP_SHAPES.values(), ids=ASPP_SHAPES.keys())
def test_aspp_kernel_matches_plain(cuda_device, shape):
    """The ASPP branch kernel on x channels-last (as the nets hold it): each
    branch within 2 bf16 ulps of its largest output of the plain convs
    (cuDNN's bf16 convs land up to 1.03 ulp from the float32 sums, the
    kernel, which rounds once, 0.5), within 1 ulp of the float32 convs of
    the same bf16 operands, and the buffer's pooled slice left as it was."""
    from pmf_tpu_torch.ops import aspp

    nb, c, h, w = shape
    g = torch.Generator().manual_seed(c + h)
    x = torch.randn(nb, c, h, w, generator=g).to(cuda_device, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    ws = [(torch.randn(c, c, k, k, generator=g) / (k * k * c) ** 0.5).to(cuda_device)
          for k in (1, 3, 3, 3)]
    bs = [(torch.randn(c, generator=g) * 0.1).to(cuda_device) for _ in range(4)]
    dil = (6, 12, 18)
    out = torch.full((nb, h, w, 5 * c), 7.0, dtype=torch.bfloat16, device=cuda_device)
    ref = torch.zeros_like(out)
    truth = ref.float()
    launches = aspp.aspp_branches.launches
    aspp.aspp_branches(x, ws, bs, dil, out)
    assert aspp.aspp_branches.launches == launches + 1
    aspp.aspp_branches_plain(x, ws, bs, dil, ref)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        aspp.aspp_branches_plain(x.float(), [t.to(torch.bfloat16).float() for t in ws], bs, dil,
                                 truth)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert (out[..., :c] == 7.0).all()
    for b in range(4):
        sl = slice(c * (1 + b), c * (2 + b))
        got, want, exact = out[..., sl].float(), ref[..., sl].float(), truth[..., sl]
        assert (got - want).abs().max() <= 2 * bf16_ulp(want.abs().max().item())
        assert (got - exact).abs().max() <= bf16_ulp(exact.abs().max().item())


@pytest.mark.cuda
def test_aspp_kernel_launches_per_eval_call(cuda_device):
    """One eval call of EPMFNet launches the ASPP kernel twice (its camera
    decoder and its lidar head), one of PMFNet once (its lidar head); with
    grad on, neither launches it."""
    from pmf_tpu_torch.models import EPMFNet, PMFNet, random_weights
    from pmf_tpu_torch.ops import aspp

    g = torch.Generator().manual_seed(0)
    pcd = torch.randn(2, 64, 256, 5, generator=g).to(cuda_device)
    img = torch.rand(2, 64, 256, 3, generator=g).to(cuda_device)
    for net, want in ((EPMFNet, 2), (PMFNet, 1)):
        model = random_weights(net(nclasses=20, base_channels=32, dtype=torch.bfloat16),
                               seed=1).to(cuda_device)
        aspp.aspp_branches.launches = 0
        with torch.inference_mode():
            model(pcd, img)
        assert aspp.aspp_branches.launches == want
        model(pcd, img)
        assert aspp.aspp_branches.launches == want


@pytest.mark.cuda
def test_aspp_conv_path_keeps_off_cudnn_direct_kernel(cuda_device):
    """With grad on (the conv path) a 512-channel ASPP on channels-last bf16
    x at EPMF's camera-decoder shape runs its forward and backward without
    cuDNN's direct conv kernel, which channels-last x sends the dilated
    convs to there (20x slower); the output is NCHW, as before."""
    from torch.profiler import ProfilerActivity, profile

    from pmf_tpu_torch.models.pmf import ASPP

    m = ASPP(512, 512).to(cuda_device, torch.bfloat16)
    x = torch.randn(8, 512, 20, 80, device=cuda_device, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    m(x).sum().backward()  # cuDNN's choices are made on the first call
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y = m(x)
        y.sum().backward()
        torch.cuda.synchronize()
    kernels = [e.key for e in prof.key_averages() if e.device_type.name == "CUDA"]
    assert kernels and not [k for k in kernels if "direct_kernel" in k]
    assert y.is_contiguous()


# (variant, N, C, H, W): the conv epilogue at shapes the main paths launch it at.
# PMF-KITTI's lidar stream at full resolution (32 and 64 channels), a 256-channel
# 1/8 map, the 20-class logits, the stem's relu, the first fusion block's
# attention, ResNet34's and ResNet50's widest blocks (layer4's relu(out + x)),
# and one keyframe item at 896x1600 (its lidar context block, its 17-class
# logits: C not a multiple of 8)
EPILOGUE_SHAPES = {
    "pmf_context_32": ("leaky_relu_bn_residual", 8, 32, 384, 1232),
    "pmf_resblock1_64": ("leaky_relu_bn", 8, 64, 384, 1232),
    "pmf_resblock4_256": ("leaky_relu_bn_residual", 8, 256, 48, 154),
    "pmf_logits_20": ("bias", 8, 20, 384, 1232),
    "r34_stem_relu": ("relu", 8, 64, 384, 1232),
    "fusion1_sigmoid": ("sigmoid", 8, 64, 192, 616),
    "r34_layer4": ("residual_relu", 8, 512, 24, 77),
    "r50_layer4_keyframe": ("residual_relu", 1, 2048, 56, 100),
    "keyframe_context_32": ("leaky_relu_bn_residual", 1, 32, 896, 1600),
    "keyframe_logits_17": ("bias", 1, 17, 896, 1600),
}
EPILOGUE_VARIANTS = {"bias": (None, False, False, None), "relu": ("relu", False, False, None),
                     "sigmoid": ("sigmoid", False, False, None),
                     "leaky_relu_bn": ("leaky_relu", True, False, None),
                     "leaky_relu_bn_residual": ("leaky_relu", True, True, None),
                     "residual_relu": (None, False, True, "relu")}


def epilogue_operands(dev, variant, nb, c, h, w, seed):
    """A conv output y (bf16, channels-last), the float32 bias, BN's a and b
    (or None), a residual (or None) and the post, on `dev`."""
    act, with_bn, with_res, post = EPILOGUE_VARIANTS[variant]
    g = torch.Generator().manual_seed(seed)
    cl = torch.channels_last
    y = (torch.randn(nb, c, h, w, generator=g) * 2).to(dev, torch.bfloat16).contiguous(
        memory_format=cl)
    bias = (torch.randn(c, generator=g) * 0.5).to(dev)
    a = (torch.rand(c, generator=g) + 0.5).to(dev) if with_bn else None
    b = (torch.randn(c, generator=g) * 0.1).to(dev) if with_bn else None
    res = torch.randn(nb, c, h, w, generator=g).to(dev, torch.bfloat16).contiguous(
        memory_format=cl) if with_res else None
    return y, bias, act, a, b, res, post


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in bf16 ulps of each element of want (ulps of
    the smallest normal at 0)."""
    w = want.float().abs().clamp_min(2.0 ** -126)
    return ((got.float() - want.float()).abs() / torch.exp2(torch.floor(torch.log2(w)) - 7)
            ).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EPILOGUE_SHAPES.values(), ids=EPILOGUE_SHAPES.keys())
def test_conv_epilogue_kernel_matches_twin(cuda_device, shape):
    """The epilogue kernel in place on y against its plain twin on the same
    card tensors: within 1 bf16 ulp of each element (both take the same
    float32 ops in the same order and round once; sigmoid's expf is the
    one op whose last bit may differ), the residual untouched, one launch."""
    from pmf_tpu_torch.ops import epilogue

    variant, nb, c, h, w = shape
    y, bias, act, a, b, res, post = epilogue_operands(cuda_device, variant, nb, c, h, w, c + h)
    res_before = None if res is None else res.clone()
    want = epilogue.conv_epilogue_plain(y.clone(), bias, act, a, b, res, post)
    launches = epilogue.conv_epilogue.launches
    got = epilogue.conv_epilogue(y, bias, act, a, b, res, post)
    torch.cuda.synchronize()
    assert got is y and epilogue.conv_epilogue.launches == launches + 1
    assert bf16_ulps(got, want) <= 1.0
    if act != "sigmoid":
        assert torch.equal(got, want)
    assert res is None or torch.equal(res, res_before)


@pytest.mark.cuda
def test_conv_epilogue_launches_per_eval_call(cuda_device):
    """One bf16 eval call of PMFNet-ResNet34 passes each of its 105 convs'
    epilogues through the kernel, one of EPMFNet-ResNet34 99, one of
    PMFNet-ResNet50 122 (the counts of tests/test_torch_epilogue.py: the
    maps stay channels-last on the card); with grad on, none."""
    from pmf_tpu_torch.models import EPMFNet, PMFNet, random_weights
    from pmf_tpu_torch.ops import epilogue

    g = torch.Generator().manual_seed(0)
    pcd = torch.randn(2, 64, 256, 5, generator=g).to(cuda_device)
    img = torch.rand(2, 64, 256, 3, generator=g).to(cuda_device)
    for net, backbone, want in ((PMFNet, "resnet34", 105), (EPMFNet, "resnet34", 99),
                                (PMFNet, "resnet50", 122)):
        model = random_weights(net(nclasses=20, base_channels=32, image_backbone=backbone,
                                   dtype=torch.bfloat16), seed=1).to(cuda_device)
        epilogue.conv_epilogue.launches = 0
        with torch.inference_mode():
            model(pcd, img)
        assert epilogue.conv_epilogue.launches == want
        model(pcd, img)
        assert epilogue.conv_epilogue.launches == want


@pytest.mark.cuda
def test_conv_epilogue_kernel_refuses_other_variants(cuda_device):
    """The library holds a kernel for each variant of ops/epilogue.py's
    VARIANTS alone: its entry point refuses any other (act, BN, residual,
    post), and leaves y as it was."""
    from pmf_tpu_torch.ops import epilogue, kernels

    y, bias, _, a, b, res, _ = epilogue_operands(cuda_device, "leaky_relu_bn_residual", 2, 16,
                                                 4, 6, 0)
    before = y.clone()
    p = lambda t: None if t is None else t.data_ptr()
    for act in epilogue.ACTS:
        for bn in (False, True):
            for r in (None, res):
                for post in epilogue.POSTS:
                    if (act, bn, r is not None, post) in epilogue.VARIANTS:
                        continue
                    with pytest.raises(RuntimeError):
                        kernels.launch("pmf_conv_epilogue", y.device, y.data_ptr(), p(r),
                                       bias.data_ptr(), p(a if bn else None),
                                       p(b if bn else None), y.numel() // 16, 16,
                                       epilogue.ACTS[act], epilogue.POSTS[post],
                                       kernels.sms(y.device))
    torch.cuda.synchronize()
    assert torch.equal(y, before)


# (case, N, C, H, W): the train-mode epilogue at the train cell's largest
# maps (batch 8, the 256x1024 crop): resBlock1's 64 channels and the context
# blocks' 32 (with their residual) at full resolution, ResNet34's stem conv
# (full resolution, before its pool), layer4's relu(BN + x) at 1/16, the
# first fusion block's attention (both convs, at 1/2) and a downsample
BN_TRAIN_SHAPES = {
    "resblock1_64": ("act_bn", 8, 64, 256, 1024),
    "context_32_residual": ("act_bn_residual", 8, 32, 256, 1024),
    "r34_stem_relu": ("bn_relu", 8, 64, 256, 1024),
    "r34_layer4_residual_relu": ("bn_residual_relu", 8, 512, 16, 64),
    "fusion1_attention_relu": ("bn_relu_bias", 8, 64, 128, 512),
    "fusion1_attention_sigmoid": ("bn_sigmoid_bias", 8, 64, 128, 512),
    "r34_layer2_downsample": ("bn", 8, 128, 64, 256),
}
# case: (family, act, residual, post, conv bias), as tests/test_torch_epilogue_train.py
BN_TRAIN_CASES = {
    "act_bn": ("act_bn", "leaky_relu", False, None, True),
    "act_bn_residual": ("act_bn", "leaky_relu", True, None, True),
    "bn_relu": ("bn_act", "relu", False, None, False),
    "bn_relu_bias": ("bn_act", "relu", False, None, True),
    "bn_sigmoid_bias": ("bn_act", "sigmoid", False, None, True),
    "bn": ("bn_act", None, False, None, False),
    "bn_residual_relu": ("bn_act", None, True, "relu", False),
}


def bn_train_operands(dev, case, nb, c, h, w, seed):
    """A conv output y and the output's gradient (bf16, channels-last; the
    gradient as the middle channels of a wider tensor, as a concatenation's
    backward gives it), the bias (or None), a residual (or None), BN's γ, β
    and running statistics (float32), on `dev`."""
    family, act, with_res, post, with_bias = BN_TRAIN_CASES[case]
    g = torch.Generator().manual_seed(seed)
    cl = torch.channels_last
    bf = lambda *shape: (torch.randn(*shape, generator=g) * 2).to(dev, torch.bfloat16)
    y = bf(nb, c, h, w).contiguous(memory_format=cl)
    wide = bf(nb, c + 16, h, w).contiguous(memory_format=cl)
    gout = wide[:, 8:8 + c]
    res = bf(nb, c, h, w).contiguous(memory_format=cl) if with_res else None
    f32 = lambda t: t.to(dev)
    bias = f32(torch.randn(c, generator=g) * 0.5) if with_bias else None
    gamma, beta = f32(torch.rand(c, generator=g) + 0.5), f32(torch.randn(c, generator=g) * 0.1)
    running = (f32(torch.randn(c, generator=g) * 0.3), f32(torch.rand(c, generator=g) + 0.5))
    return y, gout, bias, res, gamma, beta, running


def bn_train_run(fn, case, y, gout, bias, res, gamma, beta, running):
    """Forward and backward of `fn` (bn_epilogue or its twin) on copies of
    the leaves and running statistics: {name: tensor}."""
    family, act, _, post, _ = BN_TRAIN_CASES[case]
    leaf = lambda t: None if t is None else t.clone().requires_grad_()
    y, bias, res, gamma, beta = map(leaf, (y, bias, res, gamma, beta))
    running = tuple(r.clone() for r in running)
    out = fn(y, bias, gamma, beta, family, act, res, post, running)
    out.backward(gout)
    got = {"out": out.detach(), "dy": y.grad, "dgamma": gamma.grad, "dbeta": beta.grad,
           "running_mean": running[0], "running_var": running[1]}
    if bias is not None:
        got["dbias"] = bias.grad
    if res is not None:
        got["dres"] = res.grad
    return got


def beyond_ulp(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| beyond one bf16 ulp of each element of want,
    over the largest |want|: 0 where every element is within its ulp."""
    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126))) - 7)
    return (((got.float() - w).abs() - ulp).clamp_min(0).max() / w.abs().max()).item()


def bn_train_gaps(got: dict, want: dict, family: str) -> dict:
    """Each quantity's gap from the twin: the output and dy beyond one ulp
    of each element, over their largest element (`beyond_ulp`; the ulps of
    the output, for the record); the residual's gradient as the count of
    unequal elements; the per-channel vectors over their largest element
    (conv_bn's bias gradient, nought but rounding, over the largest Σ|dy|
    of a channel)."""
    gaps = {"out": beyond_ulp(got["out"], want["out"]),
            "out_ulps": bf16_ulps(got["out"], want["out"]),
            "dy": beyond_ulp(got["dy"], want["dy"])}
    if "dres" in want:
        gaps["dres_unequal"] = int((got["dres"] != want["dres"]).sum())
    for k in ("dgamma", "dbeta", "dbias", "running_mean", "running_var"):
        if k in want:
            scale = want[k].abs().max()
            if k == "dbias" and family == "bn_act":
                scale = want["dy"].float().abs().sum(dim=(0, 2, 3)).max()
            gaps[k] = ((got[k] - want[k]).abs().max() / scale).item()
    return gaps


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BN_TRAIN_SHAPES.values(), ids=BN_TRAIN_SHAPES.keys())
def test_bn_train_epilogue_kernels_match_twin(cuda_device, shape):
    """The train-mode epilogue's kernels, forward and backward, against its
    plain twin on the same card tensors, four launches. The output and dy
    within one bf16 ulp of each element and 1e-5 of their largest: each
    rounds once, but the sums behind BN's a and b and dy's coefficients run
    in other orders, so these differ in their last float32 bits, which an
    element where the terms cancel (t·a against b, or a residual) keeps
    (measured: dy within its ulp everywhere; the output 1-512 ulps of a
    near-nought element). The residual's gradient equal but at a closing
    relu's sign flips (under 1e-6 of the elements; measured none); γ, β,
    bias gradients and running statistics within 1e-5 of their largest
    element (conv_bn's bias, 1e-5 of Σ|dy|): sums of up to two million
    terms a channel in two orders (measured at most 1.6e-6)."""
    from pmf_tpu_torch.ops import epilogue_train as T

    case, nb, c, h, w = shape
    ops = bn_train_operands(cuda_device, case, nb, c, h, w, c + h)
    family = BN_TRAIN_CASES[case][0]
    want = bn_train_run(T.bn_epilogue_plain, case, *ops)
    launches = T.bn_epilogue.launches
    got = bn_train_run(T.bn_epilogue, case, *ops)
    torch.cuda.synchronize()
    assert T.bn_epilogue.launches == launches + 4
    assert got["out"].is_contiguous(memory_format=torch.channels_last)
    assert got["dy"].is_contiguous(memory_format=torch.channels_last)
    gaps = bn_train_gaps(got, want, family)
    assert gaps["out"] <= 1e-5 and gaps["dy"] <= 1e-5, gaps
    assert gaps.get("dres_unequal", 0) <= 1e-6 * got["out"].numel(), gaps
    for k in ("dgamma", "dbeta", "dbias", "running_mean", "running_var"):
        assert gaps.get(k, 0) <= 1e-5, gaps


@pytest.mark.cuda
def test_bn_train_epilogue_repeats(cuda_device):
    """Two runs on the same operands give the same bits: the sums take no
    float atomics."""
    from pmf_tpu_torch.ops import epilogue_train as T

    ops = bn_train_operands(cuda_device, "act_bn_residual", 8, 32, 64, 256, 1)
    first = bn_train_run(T.bn_epilogue, "act_bn_residual", *ops)
    second = bn_train_run(T.bn_epilogue, "act_bn_residual", *ops)
    assert all(torch.equal(first[k], second[k]) for k in first)


@pytest.mark.cuda
def test_bn_train_epilogue_launches_per_train_step(cuda_device):
    """One bf16 PMF-ResNet34 train step launches the train-mode epilogue
    4 times for each of its 94 BNs (two passes forward, two backward: 376);
    an eval forward of the same net none, and the conv epilogue of
    inference once a conv there (105); a float32 train step none."""
    from pmf_tpu_torch.models import PMFNet, random_weights
    from pmf_tpu_torch.ops import epilogue
    from pmf_tpu_torch.ops import epilogue_train as T

    g = torch.Generator().manual_seed(0)
    pcd = torch.randn(2, 64, 256, 5, generator=g).to(cuda_device)
    img = torch.rand(2, 64, 256, 3, generator=g).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for dtype, want in ((torch.bfloat16, 376), (torch.float32, 0)):
        model = random_weights(PMFNet(nclasses=20, base_channels=32, image_backbone="resnet34",
                                      dtype=dtype), seed=1).to(cuda_device).train()
        T.bn_epilogue.launches = 0
        lidar, cam = model(pcd, img, gen)
        assert T.bn_epilogue.launches == want // 2
        (lidar.square().mean() + cam.square().mean()).backward()
        torch.cuda.synchronize()
        assert T.bn_epilogue.launches == want
    T.bn_epilogue.launches = epilogue.conv_epilogue.launches = 0
    model = random_weights(PMFNet(nclasses=20, base_channels=32, image_backbone="resnet34",
                                  dtype=torch.bfloat16), seed=1).to(cuda_device).eval()
    with torch.inference_mode():
        model(pcd, img)
    assert T.bn_epilogue.launches == 0 and epilogue.conv_epilogue.launches == 105


@pytest.mark.cuda
def test_bn_train_epilogue_waits_for_no_host(cuda_device):
    """Forward and backward through the kernels under
    torch.cuda.set_sync_debug_mode("error"): nothing reads back to the host."""
    from pmf_tpu_torch.ops import epilogue_train as T

    cases = ("act_bn_residual", "bn_residual_relu", "bn_sigmoid_bias")
    ops = {case: bn_train_operands(cuda_device, case, 2, 64, 32, 64, 3) for case in cases}
    bn_train_run(T.bn_epilogue, cases[0], *ops[cases[0]])   # loads the library first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for case in cases:
            bn_train_run(T.bn_epilogue, case, *ops[case])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_bn_train_epilogue_refuses(cuda_device):
    """On the card the wrapper refuses a y that is not bf16 channels-last, a
    width or variant the kernels do not hold and a residual not laid out as
    y, and each C entry refuses a variant it was not built for, launching
    nothing."""
    from pmf_tpu_torch.ops import epilogue_train as T
    from pmf_tpu_torch.ops import kernels

    y, _, bias, _, gamma, beta, running = bn_train_operands(cuda_device, "act_bn", 2, 16, 4, 6, 0)
    calls = [dict(y=y.float()), dict(y=y.contiguous()), dict(act="relu"),
             dict(residual=y.contiguous()),
             dict(y=y[:, :12].contiguous(memory_format=torch.channels_last), bias=bias[:12],
                  weight=gamma[:12], beta=beta[:12], running=None)]
    launches = T.bn_epilogue.launches
    for kw in calls:
        call = {"y": y, "bias": bias, "weight": gamma, "beta": beta, "family": "act_bn",
                "act": "leaky_relu", "running": running, **kw}
        with pytest.raises(ValueError):
            T.bn_epilogue(**call)
    assert T.bn_epilogue.launches == launches
    stats = torch.zeros(4, 16, device=cuda_device)
    out = torch.empty_like(y)
    for family, act, post in ((0, 1, 0), (1, 2, 0), (1, 1, 1)):
        with pytest.raises(RuntimeError):
            kernels.launch("pmf_bn_train_apply", y.device, y.data_ptr(), None, bias.data_ptr(),
                           stats.data_ptr(), out.data_ptr(), y.numel() // 16, 16, family, act,
                           post, kernels.sms(y.device))


# (net, backbone, classes, H, W): the batch-1 eval forwards the per-scan and
# per-item loops replay as CUDA graphs (models/graphs.py)
GRAPH_NETS = {"pmf_r34_kitti": ("PMFNet", "resnet34", 20, 384, 1232),
              "pmf_r50_nuscenes": ("PMFNet", "resnet50", 17, 896, 1600),
              "epmf_r34_nuscenes": ("EPMFNet", "resnet34", 17, 640, 1280)}


def graph_net(dev, name: str):
    """A bf16 net of GRAPH_NETS at full width with random weights, and its
    view's (H, W)."""
    from pmf_tpu_torch import models

    net, backbone, nclasses, h, w = GRAPH_NETS[name]
    torch.manual_seed(0)
    model = models.random_weights(getattr(models, net)(
        nclasses=nclasses, base_channels=32, image_backbone=backbone, dtype=torch.bfloat16),
        seed=1).to(dev)
    return model, (h, w)


def view_features(dev, size, seeds):
    """One [H, W, 8] feature map a seed, as a per-scan view gives it."""
    return [torch.randn(*size, 8, generator=torch.Generator().manual_seed(s)).to(dev)
            for s in seeds]


def call(model, f, generator=None):
    """The net on one view's features, as the loops call it."""
    return model(f[None, ..., :5], f[None, ..., 5:8], generator)


def eager(model, f):
    """The eager forward of an eval-mode net: a generator closes the
    graphs' gate, and eval-mode dropout draws nothing from it."""
    return call(model, f, torch.Generator())


def graph_counts(model) -> tuple[int, int]:
    return type(model).graph_captures, type(model).graph_replays


def assert_same(got, want):
    """Equal bit for bit and laid out alike; the float32 ulps apart if not."""
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.stride() == w.stride()
        if not torch.equal(g, w):
            ulps = ((g - w).abs() / torch.finfo(torch.float32).eps
                    / w.abs().clamp_min(torch.finfo(torch.float32).tiny)).max().item()
            raise AssertionError(f"replay differs from the eager call: {ulps:.1f} ulps at most")


@pytest.mark.cuda
@pytest.mark.parametrize("name", GRAPH_NETS)
def test_graph_replay_equals_eager(cuda_device, name):
    """Four calls at one signature: the first eager, the second captures
    and replays, the rest replay; each output equals an eager call's on
    the same features bit for bit, and no two calls' outputs share memory."""
    model, size = graph_net(cuda_device, name)
    fs = view_features(cuda_device, size, (1, 2, 3))
    order = (fs[0], fs[1], fs[2], fs[0])
    captures, replays = graph_counts(model)
    with torch.inference_mode():
        outs = [call(model, f) for f in order]
        assert graph_counts(model) == (captures + 1, replays + 3)
        for f, out in zip(order, outs):
            assert_same(out, eager(model, f))
    assert len({o.data_ptr() for out in outs for o in out}) == 2 * len(outs)


@pytest.mark.cuda
def test_graph_replays_keep_each_calls_output(cuda_device):
    """A forward hook keeps each call's own lidar output: a later replay
    writes into none of them."""
    model, size = graph_net(cuda_device, "pmf_r34_kitti")
    fs = view_features(cuda_device, size, (4, 5, 6))
    kept = []
    hook = model.register_forward_hook(lambda _m, _a, out: kept.append(out[0][0]))
    with torch.inference_mode():
        for f in fs + fs:
            call(model, f)
        hook.remove()
        for f, k in zip(fs + fs, kept):
            assert torch.equal(k, eager(model, f)[0][0])
    assert len({k.data_ptr() for k in kept}) == len(kept)


@pytest.mark.cuda
def test_graphs_dropped_on_train_move_and_weight_load(cuda_device):
    """`train()`, `to()` and a weight load drop the graphs: the next call at
    the signature runs eagerly, the one after captures again, and after a
    load every call gives the new weights' output."""
    from pmf_tpu_torch.models import random_weights

    model, size = graph_net(cuda_device, "pmf_r34_kitti")
    f = view_features(cuda_device, size, (7,))[0]
    with torch.inference_mode():
        old = eager(model, f)
        for drop in (lambda: model.train().eval(), lambda: model.to(cuda_device),
                     lambda: random_weights(model, seed=2)):
            call(model, f)
            call(model, f)
            drop()
            captures, replays = graph_counts(model)
            first = call(model, f)
            assert graph_counts(model) == (captures, replays)
            outs = [call(model, f), call(model, f)]
            assert graph_counts(model) == (captures + 1, replays + 2)
            for out in outs:
                assert_same(out, first)
        assert_same(first, eager(model, f))
        assert not torch.equal(first[0], old[0])


@pytest.mark.cuda
def test_graphs_not_taken_at_batch_2_or_with_grad(cuda_device):
    """Batch 2 in inference and batch 1 with grad on never capture nor
    replay, nor record a signature."""
    model, size = graph_net(cuda_device, "pmf_r34_kitti")
    f = view_features(cuda_device, size, (8,))[0]
    counts = graph_counts(model)
    with torch.inference_mode():
        for _ in range(3):
            model(torch.stack([f, f])[..., :5], torch.stack([f, f])[..., 5:8])
    for _ in range(3):
        call(model, f)
    assert graph_counts(model) == counts and not model._graphs
