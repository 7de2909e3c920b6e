"""KNN 2D → 3D post-processing under the reference's name (counterpart of
`pmf_tpu/postproc/__init__.py`)."""
from ..ops.knn import gaussian_kernel2d, knn_postprocess

KNN = knn_postprocess

__all__ = ["knn_postprocess", "gaussian_kernel2d", "KNN"]
