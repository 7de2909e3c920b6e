from .jitter import color_jitter, color_jitter_fixed
from .loader import kitti_sample_reader
from .perspective_pipeline import (
    AugParams, PVConfig, build_batch, build_eval_sample_with_uproj, normalize_feature,
    pad_image, pad_points, point_depth, pv_config,
)
from .semantic_kitti import SemanticKitti
from .perspective_pipeline_v2 import (
    V2AugParams, V2Config, build_v2_batch, build_v2_eval_sample_with_uproj, v2_config,
    view_config,
)
