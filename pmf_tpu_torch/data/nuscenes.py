"""nuScenes dataset adapters (counterpart of `pmf_tpu/data/nuscenes.py`,
a copy of its host-side numpy code; the port imports nothing of pmf_tpu).

  * `NuScenesLite`: the JSON tables of a nuScenes DB indexed by token (no
    devkit);
  * `Nuscenes`: one item per (lidar, camera) pair, 6 per keyframe (or one
    per keyframe with has_image=False); the 32 → 17 class LUT; the scan,
    its lidarseg labels, the camera image (PIL, imported when an image is
    read) and the composed 3x4 lidar → image matrix
    K · T_cam_cs⁻¹ · T_cam_pose⁻¹ · T_lidar_pose · T_lidar_cs;
  * `NuscenesV2`, EPMF's variant: items in scene order with their camera
    channel, the per-camera yaw field of view, non-CAM_BACK images resized
    by (0.5 h, 0.6 w), and the lidar → camera-frame transform with the
    rescale folded into the intrinsic.

The split: `train_scene_names`, else a `splits_file` (JSON with a "train"
list, checked against the official val split), else the devkit's mini
split for v1.0-mini and the complement of the official val split for
v1.0-trainval, else every scene trains.
"""
from __future__ import annotations

import json
import os

import numpy as np

# the class mapping (dataset facts)
GENERAL_TO_SEG_CLASS = {
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.wheelchair": "ignore",
    "human.pedestrian.stroller": "ignore",
    "human.pedestrian.personal_mobility": "ignore",
    "human.pedestrian.police_officer": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "animal": "ignore",
    "vehicle.car": "car",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle",
    "vehicle.emergency.ambulance": "ignore",
    "vehicle.emergency.police": "ignore",
    "vehicle.trailer": "trailer",
    "movable_object.barrier": "barrier",
    "movable_object.trafficcone": "traffic_cone",
    "movable_object.pushable_pullable": "ignore",
    "movable_object.debris": "ignore",
    "static_object.bicycle_rack": "ignore",
    "flat.driveable_surface": "driveable_surface",
    "flat.other": "other_flat",
    "flat.sidewalk": "sidewalk",
    "flat.terrain": "terrain",
    "static.manmade": "manmade",
    "static.vegetation": "vegetation",
    "noise": "ignore",
    "static.other": "ignore",
    "vehicle.ego": "ignore",
}

SEG_CLASS_TO_INDEX = {
    "ignore": 0, "barrier": 1, "bicycle": 2, "bus": 3, "car": 4,
    "construction_vehicle": 5, "motorcycle": 6, "pedestrian": 7,
    "traffic_cone": 8, "trailer": 9, "truck": 10, "driveable_surface": 11,
    "other_flat": 12, "sidewalk": 13, "terrain": 14, "manmade": 15,
    "vegetation": 16,
}

# the devkit's mini split (nuscenes/utils/splits.py: mini_train, mini_val)
MINI_TRAIN = ["scene-0061", "scene-0553", "scene-0655", "scene-0757",
              "scene-0796", "scene-1077", "scene-1094", "scene-1100"]
MINI_VAL = ["scene-0103", "scene-0916"]

# the devkit's val split (nuscenes/utils/splits.py: val, 150 scenes); a
# v1.0-trainval DB holds the 850 train and val scenes, so the 700 train
# scenes are its complement
VAL_SCENES = [
    "scene-0003", "scene-0012", "scene-0013", "scene-0014", "scene-0015",
    "scene-0016", "scene-0017", "scene-0018", "scene-0035", "scene-0036",
    "scene-0038", "scene-0039", "scene-0092", "scene-0093", "scene-0094",
    "scene-0095", "scene-0096", "scene-0097", "scene-0098", "scene-0099",
    "scene-0100", "scene-0101", "scene-0102", "scene-0103", "scene-0104",
    "scene-0105", "scene-0106", "scene-0107", "scene-0108", "scene-0109",
    "scene-0110", "scene-0221", "scene-0268", "scene-0269", "scene-0270",
    "scene-0271", "scene-0272", "scene-0273", "scene-0274", "scene-0275",
    "scene-0276", "scene-0277", "scene-0278", "scene-0329", "scene-0330",
    "scene-0331", "scene-0332", "scene-0344", "scene-0345", "scene-0346",
    "scene-0519", "scene-0520", "scene-0521", "scene-0522", "scene-0523",
    "scene-0524", "scene-0552", "scene-0553", "scene-0554", "scene-0555",
    "scene-0556", "scene-0557", "scene-0558", "scene-0559", "scene-0560",
    "scene-0561", "scene-0562", "scene-0563", "scene-0564", "scene-0565",
    "scene-0625", "scene-0626", "scene-0627", "scene-0629", "scene-0630",
    "scene-0632", "scene-0633", "scene-0634", "scene-0635", "scene-0636",
    "scene-0637", "scene-0638", "scene-0770", "scene-0771", "scene-0775",
    "scene-0777", "scene-0778", "scene-0780", "scene-0781", "scene-0782",
    "scene-0783", "scene-0784", "scene-0794", "scene-0795", "scene-0796",
    "scene-0797", "scene-0798", "scene-0799", "scene-0800", "scene-0802",
    "scene-0904", "scene-0905", "scene-0906", "scene-0907", "scene-0908",
    "scene-0909", "scene-0910", "scene-0911", "scene-0912", "scene-0913",
    "scene-0914", "scene-0915", "scene-0916", "scene-0917", "scene-0919",
    "scene-0920", "scene-0921", "scene-0922", "scene-0923", "scene-0924",
    "scene-0925", "scene-0926", "scene-0927", "scene-0928", "scene-0929",
    "scene-0930", "scene-0931", "scene-0962", "scene-0963", "scene-0966",
    "scene-0967", "scene-0968", "scene-0969", "scene-0971", "scene-0972",
    "scene-1059", "scene-1060", "scene-1061", "scene-1062", "scene-1063",
    "scene-1064", "scene-1065", "scene-1066", "scene-1067", "scene-1068",
    "scene-1069", "scene-1070", "scene-1071", "scene-1072", "scene-1073",
]



CAMERAS = ["CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_BACK_RIGHT", "CAM_BACK",
           "CAM_BACK_LEFT", "CAM_FRONT_LEFT"]

# EPMF's per-camera yaw field of view, degrees (fov_left, fov_right)
FOV_ANGLE_V2 = {
    "CAM_FRONT": (-35.0, 35.0),
    "CAM_FRONT_RIGHT": (-40.0, 40.0),
    "CAM_BACK_RIGHT": (-45.0, 45.0),
    "CAM_BACK": (-50.0, 50.0),
    "CAM_BACK_LEFT": (-45.0, 45.0),
    "CAM_FRONT_LEFT": (-40.0, 40.0),
}


def _resolve_train_scenes(version: str, scene_by_name: dict, train_scene_names, splits_file):
    """The train scenes' names: `train_scene_names`, else the "train" list of
    `splits_file` (which raises if it shares a scene with the official val
    split in a DB that holds that whole split), else the mini split's
    (v1.0-mini) or the complement of the val split (v1.0-trainval), else
    None: every scene trains."""
    if train_scene_names is not None:
        return train_scene_names
    if splits_file:
        with open(splits_file) as f:
            names = json.load(f)["train"]
        overlap = [n for n in VAL_SCENES if n in scene_by_name]
        if len(overlap) == len(VAL_SCENES):
            bad = sorted(set(names) & set(VAL_SCENES))
            if bad:
                raise ValueError(f"splits_file train list intersects the official val "
                                 f"split ({len(bad)} scenes, e.g. {bad[:3]})")
        return names
    if version == "v1.0-mini":
        present = [n for n in MINI_TRAIN if n in scene_by_name]
        return present or None
    if version == "v1.0-trainval":
        val = set(VAL_SCENES)
        return [n for n in scene_by_name if n not in val]
    return None


def quaternion_rotation_matrix(q) -> np.ndarray:
    """Rotation matrix of the quaternion [w, x, y, z] (pyquaternion's order)."""
    w, x, y, z = [float(v) for v in q]
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _pose_matrix(record, inverse: bool = False) -> np.ndarray:
    """The 4x4 transform of a calibrated_sensor or ego_pose record (the
    devkit's transform_matrix), or its inverse."""
    R = quaternion_rotation_matrix(record["rotation"])
    t = np.asarray(record["translation"], dtype=np.float64)
    T = np.eye(4)
    if inverse:
        T[:3, :3] = R.T
        T[:3, 3] = -R.T @ t
    else:
        T[:3, :3] = R
        T[:3, 3] = t
    return T


class NuScenesLite:
    """A nuScenes DB's JSON tables, each indexed by token."""

    TABLES = ["category", "sample", "sample_data", "calibrated_sensor", "ego_pose", "scene"]
    OPTIONAL = ["lidarseg"]

    def __init__(self, dataroot: str, version: str = "v1.0-trainval"):
        self.dataroot = dataroot
        self.version = version
        table_dir = os.path.join(dataroot, version)
        self._tables: dict[str, dict] = {}
        self._lists: dict[str, list] = {}
        for name in self.TABLES + self.OPTIONAL:
            path = os.path.join(table_dir, f"{name}.json")
            if not os.path.isfile(path):
                if name in self.OPTIONAL:
                    self._tables[name], self._lists[name] = {}, []
                    continue
                raise FileNotFoundError(path)
            with open(path) as f:
                rows = json.load(f)
            self._lists[name] = rows
            self._tables[name] = {r["token"]: r for r in rows}
            if name == "lidarseg":
                # the devkit looks a lidarseg record up by its sample_data
                # token: real DBs use that token, made-up ones may not
                for r in rows:
                    self._tables[name].setdefault(r.get("sample_data_token", r["token"]), r)
        # lidarseg index → raw class name (the category table's `index`)
        self.lidarseg_idx2name = {cat["index"]: cat["name"]
                                  for cat in self._lists["category"] if "index" in cat}

    def get(self, table: str, token: str) -> dict:
        return self._tables[table][token]

    @property
    def sample(self):
        return self._lists["sample"]

    @property
    def scene(self):
        return self._lists["scene"]


def _train_tokens(nusc: NuScenesLite, version, train_scene_names, splits_file) -> set:
    scene_by_name = {s["name"]: s["token"] for s in nusc.scene}
    names = _resolve_train_scenes(version, scene_by_name, train_scene_names, splits_file)
    if names is None:
        return set(scene_by_name.values())
    return {scene_by_name[n] for n in names if n in scene_by_name}


class Nuscenes:
    """The reference's adapter API (loadDataByIndex, loadImage,
    labelMapping, projection_matrix, ...). Each item is one (lidar, camera)
    pair, 6 consecutive items a keyframe; with has_image=False one lidar
    item a keyframe. "train" and "test" take the train scenes, "val" the
    others."""

    def __init__(self, root: str, version: str = "v1.0-trainval", split: str = "train",
                 has_image: bool = True, train_scene_names=None, splits_file: str | None = None):
        self.nusc = NuScenesLite(root, version)
        self.split = split
        self.data_path = root
        self.has_image = has_image

        # raw lidarseg index → 17-class train index
        max_idx = max(self.nusc.lidarseg_idx2name, default=0)
        self.class_map_lut = np.zeros((max_idx + 100,), dtype=np.int32)
        for idx, name in self.nusc.lidarseg_idx2name.items():
            self.class_map_lut[idx] = SEG_CLASS_TO_INDEX[GENERAL_TO_SEG_CLASS[name]]
        self.mapped_cls_name = {v: k for k, v in SEG_CLASS_TO_INDEX.items()}

        train_tokens = _train_tokens(self.nusc, version, train_scene_names, splits_file)
        train_list, val_list = [], []
        for sample in self.nusc.sample:
            target = train_list if sample["scene_token"] in train_tokens else val_list
            lidar_token = sample["data"]["LIDAR_TOP"]
            if has_image:
                target.extend({"lidar_token": lidar_token, "cam_token": sample["data"][cam]}
                              for cam in CAMERAS)
            else:
                target.append({"lidar_token": lidar_token})
        if split not in ("train", "test", "val"):
            raise ValueError(f"invalid split mode: {split}")
        self.token_list = val_list if split == "val" else train_list

    def __len__(self):
        return len(self.token_list)

    def parsePathInfoByIndex(self, index: int):
        return index, self.token_list[index]["lidar_token"]

    def lidar_token(self, index: int) -> str:
        return self.token_list[index]["lidar_token"]

    def _read_labels(self, lidar_token: str) -> np.ndarray:
        seg = self.nusc.get("lidarseg", lidar_token)
        return np.fromfile(os.path.join(self.data_path, seg["filename"]),
                           dtype=np.uint8).astype(np.int32)

    def loadDataByIndex(self, index: int):
        """(points [N, 4] x/y/z/intensity, raw labels [N] (0 on the test
        split or without lidarseg), instance labels [N] zeros)."""
        lidar_token = self.token_list[index]["lidar_token"]
        sd = self.nusc.get("sample_data", lidar_token)
        raw = np.fromfile(os.path.join(self.data_path, sd["filename"]),
                          dtype=np.float32).reshape(-1, 5)
        pointcloud = raw[:, :4]
        if self.split == "test" or not self.nusc._tables["lidarseg"]:
            sem_label = np.zeros((pointcloud.shape[0],), dtype=np.int32)
        else:
            sem_label = self._read_labels(lidar_token)
        return pointcloud, sem_label, np.zeros(pointcloud.shape[0], dtype=np.int32)

    def loadLabelByIndex(self, index: int):
        label = self._read_labels(self.token_list[index]["lidar_token"])
        return label, np.zeros_like(label)

    def labelMapping(self, sem_label: np.ndarray) -> np.ndarray:
        return self.class_map_lut[sem_label]

    def _image(self, index: int):
        from PIL import Image

        cam = self.nusc.get("sample_data", self.token_list[index]["cam_token"])
        return Image.open(os.path.join(self.data_path, cam["filename"]))

    def loadImage(self, index: int) -> np.ndarray:
        return np.asarray(self._image(index))

    def _chain(self, index: int):
        """(lidar → camera-frame 4x4 transform, the camera's intrinsic 3x3),
        float64."""
        rec = self.token_list[index]
        lidar_sd = self.nusc.get("sample_data", rec["lidar_token"])
        cam_sd = self.nusc.get("sample_data", rec["cam_token"])
        l_cs = self.nusc.get("calibrated_sensor", lidar_sd["calibrated_sensor_token"])
        l_pose = self.nusc.get("ego_pose", lidar_sd["ego_pose_token"])
        c_pose = self.nusc.get("ego_pose", cam_sd["ego_pose_token"])
        c_cs = self.nusc.get("calibrated_sensor", cam_sd["calibrated_sensor_token"])
        M = (_pose_matrix(c_cs, inverse=True) @ _pose_matrix(c_pose, inverse=True)
             @ _pose_matrix(l_pose) @ _pose_matrix(l_cs))
        return M, np.asarray(c_cs["camera_intrinsic"], dtype=np.float64)

    def projection_matrix(self, index) -> np.ndarray:
        """The composed 3x4 lidar → image matrix of item `index`, float32."""
        if isinstance(index, str):
            raise TypeError("projection_matrix takes an item index")
        M, K = self._chain(index)
        return (K @ M[:3]).astype(np.float32)


class NuscenesV2(Nuscenes):
    """EPMF's adapter: the items in scene order with their camera channel,
    each camera's yaw field of view, non-CAM_BACK images resized by
    (0.5 h, 0.6 w), and `camera_transform` for the camera-frame view."""

    def __init__(self, root, version="v1.0-trainval", split="train", has_image=True,
                 train_scene_names=None, splits_file=None):
        super().__init__(root, version=version, split=split, has_image=has_image,
                         train_scene_names=train_scene_names, splits_file=splits_file)
        if not has_image:
            return
        train_tokens = _train_tokens(self.nusc, version, train_scene_names, splits_file)
        samples_by_scene: dict = {}
        for sample in self.nusc.sample:
            samples_by_scene.setdefault(sample["scene_token"], []).append(sample)
        train_list, val_list = [], []
        for scene in self.nusc.scene:
            target = train_list if scene["token"] in train_tokens else val_list
            for sample in samples_by_scene.get(scene["token"], []):
                target.extend({"lidar_token": sample["data"]["LIDAR_TOP"],
                               "cam_token": sample["data"][cam], "cam_channel": cam}
                              for cam in CAMERAS)
        self.token_list = val_list if split == "val" else train_list

    def cam_channel(self, index: int) -> str:
        return self.token_list[index]["cam_channel"]

    def fov(self, index: int):
        """The camera's (fov_left, fov_right), radians."""
        left, right = FOV_ANGLE_V2[self.cam_channel(index)]
        return (left / 180.0 * np.pi, right / 180.0 * np.pi)

    def image_scale(self, index: int):
        """(row scale, column scale) of the item's image."""
        return (1.0, 1.0) if self.cam_channel(index) == "CAM_BACK" else (0.5, 0.6)

    def loadImage(self, index: int) -> np.ndarray:
        from PIL import Image

        img = self._image(index)
        sr, sc = self.image_scale(index)
        if (sr, sc) != (1.0, 1.0):
            img = img.resize((int(img.width * sc), int(img.height * sr)), Image.BILINEAR)
        return np.asarray(img)

    def camera_transform(self, index: int):
        """(M [4, 4] lidar → camera frame, K' [3, 3] the intrinsic with the
        image's rescale folded in), float32."""
        M, K = self._chain(index)
        sr, sc = self.image_scale(index)
        S = np.diag([sc, sr, 1.0])      # u scales with the width, v with the height
        return M.astype(np.float32), (S @ K).astype(np.float32)
