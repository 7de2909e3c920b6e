from .knn import knn_postprocess
from .projection import (perspective_project, perspective_project_cam, read_kitti_calib,
                         yaw_crop_project)
from .rasterize import rasterize_zbuffer, rasterize_zbuffer_plain
from .reduce import argmax_last
from .resize import pixel_shuffle, upsample_bilinear
from .scatter import (fill_canvas, point_winner_flags, rasterize_unique,
                      zbuffer_scatter_packed)
from .zbuffer import zbuffer_keys, zbuffer_keys_plain
