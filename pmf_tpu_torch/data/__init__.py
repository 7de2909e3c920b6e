from .jitter import color_jitter, color_jitter_fixed
from .augment import AugmentConfig, PointAugParams, augment_pointcloud
from .a2d2 import A2D2_PV
from .loader import (HostLoader, a2d2_sample_reader, kitti_sample_reader, nuscenes_sample_reader,
                     nuscenes_v2_sample_reader, range_sample_reader, sensat_sample_reader)
from .nuscenes import Nuscenes, NuScenesLite, NuscenesV2
from .perspective_pipeline import (
    AugParams, PVConfig, build_batch, build_eval_sample_with_uproj, normalize_feature,
    pad_image, pad_points, point_depth, pv_config,
)
from .semantic_kitti import SemanticKitti
from .perspective_pipeline_v2 import (
    V2AugParams, V2Config, build_v2_batch, build_v2_batch_pix, build_v2_eval_sample_with_uproj,
    v2_config, view_config,
)
from .range_pipeline import (
    RangeConfig, build_range_batch, build_range_sample_with_uproj, normalize_range_feature,
    range_config, range_project,
)
from .sensat_urban import (SensatAugParams, SensatConfig, SensatUrban, build_sensat_batch,
                           compute_bev_feature, prepare_bev_frames, read_ply, sensat_config,
                           sensat_frame_weights, write_ply)
