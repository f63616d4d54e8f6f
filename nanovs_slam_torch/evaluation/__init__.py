"""Evaluation metrics, the counterparts of ``nanovs_slam_tpu/evaluation``:
numpy on the host, with ``homography.find_homography_ransac`` in place of
cv2's and the retrieval search in torch on the descriptors' device."""

from .detector import compute_repeatability  # noqa: F401
from .descriptor import compute_homography, compute_matching_score  # noqa: F401
from .keypoints import evaluate_keypoint_net, cal_error_auc  # noqa: F401
from .segmentation import evaluate_segmentation, segmentation_stats  # noqa: F401
from .global_descriptor import evaluate_global_descriptor  # noqa: F401
from .depth import compute_depth_errors, evaluate_depth  # noqa: F401
