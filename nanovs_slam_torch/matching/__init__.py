"""LightGlue matching: the module, its configs, the KP2DTiny extractor and
the pair-matching entry point (``pair.make_pair_matcher``)."""

from .configs import LIGHTGLUE_CONFIGS, LightGlueConfig  # noqa: F401
from .lightglue import (LightGlue, filter_matches,  # noqa: F401
                        normalize_keypoints)
