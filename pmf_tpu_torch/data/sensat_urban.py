"""SensatUrban on the bird's-eye view (counterpart of
`pmf_tpu/data/sensat_urban.py`; its numpy half is copied, the port imports
nothing of pmf_tpu).

  * `read_ply`/`write_ply`: binary little-endian PLY;
  * `compute_bev_feature`: a 0.1 m grid over a point cloud → the 8-channel
    map [max z, min z, mean z, log10(1 + count), occupancy, R, G, B of the
    highest point], the label map (the highest point's class, -1 empty) and
    each point's cell (h_idx, w_idx); `prepare_bev_frames` writes one .npz
    frame per .ply;
  * `SensatUrban`: the frames of a split (.npz, or .pth through torch.load),
    whole or tiled; `sensat_frame_weights`: the area-weighted train index;
  * `build_sensat_batch`: the batch on the device. Eval: the frames as they
    are, labels shifted by one (0 = empty). Train: a random crop, a rotation
    in (-π, π) by nearest sampling, horizontal and vertical flips, redrawn
    while fewer than `min_valid` of the pixels are labelled (at most
    `max_resample` times), then an RGB jitter of ±0.2 and a height jitter of
    ±2 on the occupied pixels.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..parallel import rand_rows

CLASS_NAMES = {
    -1: "ignore",
    0: "Ground", 1: "High Vegetation", 2: "Buildings", 3: "Walls",
    4: "Bridge", 5: "Parking", 6: "Rail", 7: "traffic Roads",
    8: "Street Furniture", 9: "Cars", 10: "Footpath", 11: "Bikes",
    12: "Water",
}

_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}


def read_ply(filename: str) -> dict:
    """A binary little-endian PLY file's vertex properties:
    {name: np.ndarray}."""
    with open(filename, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"not a ply file: {filename}")
        fmt = f.readline().strip()
        if b"binary_little_endian" not in fmt:
            raise ValueError(f"unsupported ply format: {fmt}")
        n_points = 0
        props = []
        while True:
            line = f.readline().strip().decode()
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "element" and parts[1] == "vertex":
                n_points = int(parts[2])
            elif parts[0] == "property":
                props.append((parts[2], _PLY_TYPES[parts[1]]))
        dtype = np.dtype([(n, "<" + t) for n, t in props])
        data = np.frombuffer(f.read(n_points * dtype.itemsize), dtype=dtype)
    return {n: np.ascontiguousarray(data[n]) for n, _ in props}


def write_ply(filename: str, fields: dict):
    """Write {name: array} as the vertices of a binary little-endian PLY."""
    names = list(fields.keys())
    n = len(fields[names[0]])
    inv = {v: k for k, v in _PLY_TYPES.items() if len(k) > 2}
    with open(filename, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        arrays = []
        for name in names:
            arr = np.ascontiguousarray(fields[name])
            code = arr.dtype.str.lstrip("<>|=")
            f.write(f"property {inv[code]} {name}\n".encode())
            arrays.append(arr)
        f.write(b"end_header\n")
        rec = np.rec.fromarrays(arrays, names=names)
        f.write(rec.tobytes())


def compute_bev_feature(pointcloud: np.ndarray, grid_size: float = 0.1) -> dict:
    """pointcloud [N, 7] = x, y, z, r, g, b, label → {feature_map [8, H, W]
    float32, label_map [H, W] float32 (-1 empty), h_idx, w_idx [N] int32},
    computed in float64."""
    x, y, z = pointcloud[:, 0], pointcloud[:, 1], pointcloud[:, 2]
    h_idx = ((y - y.min()) / grid_size).astype(np.int32)
    w_idx = ((x - x.min()) / grid_size).astype(np.int32)
    H = int(h_idx.max()) + 1
    W = int(w_idx.max()) + 1
    pix = h_idx.astype(np.int64) * W + w_idx

    feat = np.zeros((8, H * W), dtype=np.float64)
    label = np.full((H * W,), -1.0)

    feat[0].fill(-np.inf)
    feat[1].fill(np.inf)
    np.maximum.at(feat[0], pix, z)
    np.minimum.at(feat[1], pix, z)
    np.add.at(feat[2], pix, z)              # sum of z
    np.add.at(feat[3], pix, 1.0)            # count
    occupied = feat[3] > 0
    feat[4] = occupied.astype(np.float64)

    # RGB and label of each cell's highest point: the first of a (pix, -z) sort
    order = np.lexsort((-z, pix))
    first = np.ones(len(pix), dtype=bool)
    first[1:] = pix[order][1:] != pix[order][:-1]
    win = order[first]
    feat[5][pix[win]] = pointcloud[win, 3]
    feat[6][pix[win]] = pointcloud[win, 4]
    feat[7][pix[win]] = pointcloud[win, 5]
    label[pix[win]] = pointcloud[win, 6]

    feat[2] = feat[2] / (feat[3] + 1e-6)
    feat[3] = np.log10(feat[3] + 1.0)
    feat[0][~occupied] = 0.0
    feat[1][~occupied] = 0.0

    return {
        "feature_map": feat.reshape(8, H, W).astype(np.float32),
        "label_map": label.reshape(H, W).astype(np.float32),
        "h_idx": h_idx, "w_idx": w_idx,
    }


def prepare_bev_frames(root: str, split: str, grid_size: float = 0.1,
                       has_label: bool = True) -> int:
    """Each <root>/<split>/*.ply → a .npz BEV frame beside it; returns the
    count."""
    src = os.path.join(root, split)
    n = 0
    for fn in sorted(os.listdir(src)):
        if not fn.endswith(".ply"):
            continue
        data = read_ply(os.path.join(src, fn))
        label = data["class"] if has_label and "class" in data else \
            np.zeros_like(data["x"])
        pc = np.vstack([data["x"], data["y"], data["z"], data["red"],
                        data["green"], data["blue"], label]).T
        out = compute_bev_feature(pc, grid_size)
        np.savez_compressed(
            os.path.join(src, fn.replace(".ply", ".npz")),
            feature_map=out["feature_map"], label_map=out["label_map"],
            h_idx=out["h_idx"], w_idx=out["w_idx"])
        n += 1
    return n


class SensatUrban:
    """The BEV frames of a split (`.npz`, or `.pth` through torch.load;
    cambridge_block_1 is left out), each {feature_map, label_map, h_idx,
    w_idx} (the indices with `keep_idx` only); with `use_crop` each frame is
    tiled into img_h x img_w frames."""

    def __init__(self, root_path: str, split: str = "train",
                 keep_idx: bool = False, img_h: int = 320, img_w: int = 320,
                 use_crop: bool = False):
        if split not in ("train", "val", "test"):
            raise ValueError(f"invalid split: {split}")
        self.split = split
        self.split_folder = os.path.join(root_path, split)
        self.mapped_cls_name = CLASS_NAMES
        self.data_split = sorted(
            f for f in os.listdir(self.split_folder)
            if (f.endswith(".npz") or f.endswith(".pth"))
            and "cambridge_block_1" not in f)

        self.all_data_frame = []
        for fn in self.data_split:
            path = os.path.join(self.split_folder, fn)
            if fn.endswith(".npz"):
                z = np.load(path)
                frame = {"feature_map": z["feature_map"],
                         "label_map": z["label_map"],
                         "h_idx": z["h_idx"] if keep_idx else None,
                         "w_idx": z["w_idx"] if keep_idx else None}
            else:
                d = torch.load(path, weights_only=False)
                frame = {"feature_map": np.asarray(d["feature_map"], dtype=np.float32),
                         "label_map": np.asarray(d["label_map"], dtype=np.float32),
                         "h_idx": d.get("h_idx") if keep_idx else None,
                         "w_idx": d.get("w_idx") if keep_idx else None}
            if use_crop:
                self.all_data_frame.extend(_tile_frame(frame, img_h, img_w))
            else:
                self.all_data_frame.append(frame)

    def readDataByIndex(self, index: int) -> dict:
        return self.all_data_frame[index]

    def readFileNameByIndex(self, index: int) -> str:
        base = self.data_split[index]
        return base.rsplit(".", 1)[0] + ".bin"

    def readLabelByIndex(self, index: int) -> np.ndarray:
        path = os.path.join(self.split_folder, self.readFileNameByIndex(index))
        return np.fromfile(path, dtype=np.uint8)

    def __len__(self):
        return len(self.all_data_frame)


def _tile_frame(frame, img_h, img_w):
    """img_h x img_w tiles of a frame, the last row and column of tiles
    snapped back inside the frame; a frame smaller than a tile is padded
    with zeros (its labels too)."""
    fm, lm = frame["feature_map"], frame["label_map"]
    h, w = fm.shape[1], fm.shape[2]
    out = []
    for r in range(math.ceil(h / img_h)):
        h0 = min(r * img_h, max(h - img_h, 0))
        h1 = min(h0 + img_h, h)
        for c in range(math.ceil(w / img_w)):
            w0 = min(c * img_w, max(w - img_w, 0))
            w1 = min(w0 + img_w, w)
            nf = np.zeros((8, img_h, img_w), np.float32)
            nl = np.zeros((img_h, img_w), np.float32)
            nf[:, : h1 - h0, : w1 - w0] = fm[:, h0:h1, w0:w1]
            nl[: h1 - h0, : w1 - w0] = lm[h0:h1, w0:w1]
            out.append({"feature_map": nf, "label_map": nl})
    return out


@dataclass(frozen=True)
class SensatConfig:
    img_h: int = 320
    img_w: int = 320
    max_resample: int = 10       # redraws of the train crop at most
    min_valid: float = 0.1       # the least labelled share of a train crop


def sensat_config(opts, train: bool) -> SensatConfig:
    """The SensatConfig of an experiment's Options (its `sensor` group): the
    train crop proj_ht x proj_wt, or the eval tile proj_h x proj_w."""
    sensor = opts.group("sensor")
    h, w = ("proj_ht", "proj_wt") if train else ("proj_h", "proj_w")
    return SensatConfig(img_h=int(sensor.get(h, 320)), img_w=int(sensor.get(w, 320)))


def sensat_frame_weights(dataset, n_samples_split: int):
    """The train index: each frame repeated by its area in 4000 x 4000
    cells times `n_samples_split`, at least once."""
    idx_list = []
    for i in range(len(dataset)):
        fm = dataset.readDataByIndex(i)["feature_map"]
        n = int(n_samples_split * fm.shape[1] / 4000 * fm.shape[2] / 4000)
        idx_list += [i] * max(n, 1)
    return idx_list


class SensatAugParams(NamedTuple):
    """The train crop's draws: for each sample and each of the 1 +
    max_resample attempts ([B, A]) the rotation theta (radians, float32),
    the crop corner top/left (int) and the horizontal/vertical flips
    (bool); per sample ([B]) the RGB and height jitters (float32)."""
    theta: torch.Tensor
    top: torch.Tensor
    left: torch.Tensor
    fliph: torch.Tensor
    flipv: torch.Tensor
    rgb: torch.Tensor
    height: torch.Tensor


def draw_sensat_aug(generator: torch.Generator, B: int, Hf: int, Wf: int,
                    cfg: SensatConfig) -> SensatAugParams:
    """The train crop's draws from `generator`: theta ~ U(-π, π), the
    corner uniform over the frame's slack, each flip with probability 0.5,
    the RGB jitter ~ U(-0.2, 0.2) and the height jitter ~ U(-2, 2); this
    process's rows of the global batch's draws (`parallel.rand_rows`)."""
    dev = generator.device
    A = 1 + cfg.max_resample
    u = rand_rows((B, A, 5), generator, dev)
    j = rand_rows((B, 2), generator, dev)
    corner = lambda v, slack: torch.clamp((v * (slack + 1)).long(), max=slack)
    return SensatAugParams(
        (u[..., 0] * 2.0 - 1.0) * math.pi, corner(u[..., 1], max(Hf - cfg.img_h, 0)),
        corner(u[..., 2], max(Wf - cfg.img_w, 0)), u[..., 3] < 0.5, u[..., 4] < 0.5,
        j[:, 0] * 0.4 - 0.2, j[:, 1] * 4.0 - 2.0)


def build_sensat_batch(feature_map, label_map, cfg: SensatConfig, train: bool,
                       generator: torch.Generator | None = None,
                       aug_override: SensatAugParams | None = None,
                       return_attempts: bool = False):
    """Frames feature_map [B, 8, Hf, Wf], label_map [B, Hf, Wf] (-1 empty) →
    (feature [B, h, w, 8], label [B, h, w] int32, 0 empty and classes
    shifted by one). Eval: the frames as they are. Train: each of the 1 +
    max_resample attempts samples a crop of cfg.img_h x cfg.img_w
    (vertical, then horizontal flip of the output grid, rotation by theta
    about its centre, shifted to the corner; the nearest source pixel,
    rounded half to even; outside the frame features 0 and label -1), all
    in one gather; the first attempt whose labelled share reaches
    cfg.min_valid is kept, else the last: what a loop redrawing until then
    returns. The draws come from `generator` or `aug_override`. With
    return_attempts (train) a third element gives the attempts each sample
    took [B]."""
    B, _, Hf, Wf = feature_map.shape
    if not train:
        lab = ((label_map + 1) * feature_map[:, 4]).to(torch.int32)
        return feature_map.permute(0, 2, 3, 1), lab
    aug = aug_override
    if aug is None:
        if generator is None:
            raise ValueError("the train crop draws from a torch.Generator")
        aug = draw_sensat_aug(generator, B, Hf, Wf, cfg)
    dev = feature_map.device
    h, w = cfg.img_h, cfg.img_w
    b4 = lambda t: t[..., None, None]                          # [B, A] → [B, A, 1, 1]
    yo = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xo = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    yo = torch.where(b4(aug.flipv), h - 1 - yo, yo)
    xo = torch.where(b4(aug.fliph), w - 1 - xo, xo)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    theta = aug.theta.float()
    ct, st = b4(torch.cos(theta)), b4(torch.sin(theta))
    dy, dx = yo - cy, xo - cx
    sy = b4(aug.top.float()) + cy + (st * dx + ct * dy)
    sx = b4(aug.left.float()) + cx + (ct * dx - st * dy)
    iy = torch.round(sy).to(torch.int32).clamp(0, Hf - 1)
    ix = torch.round(sx).to(torch.int32).clamp(0, Wf - 1)
    inb = (sy >= -0.5) & (sy < Hf - 0.5) & (sx >= -0.5) & (sx < Wf - 0.5)
    A = iy.shape[1]
    idx = (iy.long() * Wf + ix.long()).reshape(B, A * h * w)        # [B, A·h·w]

    # every attempt's labels, then the first attempt that passes (else the last)
    lab_all = torch.where(inb, label_map.reshape(B, -1).gather(1, idx).reshape(B, A, h, w),
                          -1.0)
    share = (lab_all >= 0).float().mean(dim=(-2, -1))                # [B, A]
    attempts = torch.arange(A, device=dev)
    pick = torch.where(share >= cfg.min_valid, attempts, A).amin(-1).clamp(max=A - 1)
    rows = torch.arange(B, device=dev)
    sel_idx = idx.reshape(B, A, h * w)[rows, pick]                   # [B, h·w]
    sel_inb = inb[rows, pick]                                        # [B, h, w]
    feat = feature_map.reshape(B, 8, -1).gather(2, sel_idx[:, None].expand(B, 8, h * w))
    feat = torch.where(sel_inb[:, None], feat.reshape(B, 8, h, w), 0.0)
    lab = lab_all[rows, pick]

    mask = feat[:, 4:5]
    b3 = lambda t: t.float()[:, None, None, None]
    feat = torch.cat([(feat[:, 0:3] + b3(aug.height)) * mask, feat[:, 3:5],
                      (feat[:, 5:8] + b3(aug.rgb)) * mask], dim=1)
    out = feat.permute(0, 2, 3, 1), ((lab + 1) * feat[:, 4]).to(torch.int32)
    return (*out, pick + 1) if return_attempts else out
