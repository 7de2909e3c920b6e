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
