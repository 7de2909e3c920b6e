from .loader import kitti_sample_reader
from .perspective_pipeline import (
    PVConfig, build_batch, build_eval_sample_with_uproj, normalize_feature,
    pad_image, pad_points, point_depth,
)
from .semantic_kitti import SemanticKitti
