"""Visual odometry, the counterpart of ``nanovs_slam_tpu/vo``: the
frontend, matchers, pose estimation (host cv2 and the device RANSAC) and
the online VO loop and the offline sequence VO. cv2 is imported only where
it runs."""

from .camera import PinholeCamera  # noqa: F401
from .frontend import KP2DTinyFrontend  # noqa: F401
from .groundtruth import KittiVideoGroundTruth  # noqa: F401
from .matcher import knn2, ratio_test_match_one_to_one  # noqa: F401
from .pose import (calculate_error_stats, calculate_pose_error,  # noqa: F401
                   calculate_relative_error, estimate_pose)
from .offline import OfflineVO  # noqa: F401
from .visual_odometry import VisualOdometry  # noqa: F401
