"""LightGlue configuration and the configs for KP2DTiny backbones.

A copy of ``LightGlueConfig`` (``nanovs_slam_tpu/matching/lightglue.py``)
and of ``LIGHTGLUE_CONFIGS`` and ``GLUEFACTORY_PRESETS``
(``nanovs_slam_tpu/matching/configs.py``), so that the port does not
import the JAX package. ``dtype`` is a string. Reference:
lightglue/lightglue_configs.py:1-30 (4 layers, descriptor dim 32 for the
S/A variants, 64 for F, 4 heads).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LightGlueConfig:
    input_dim: int = 256
    descriptor_dim: int = 256
    n_layers: int = 9
    num_heads: int = 4
    add_scale_ori: bool = False
    filter_threshold: float = 0.0
    depth_confidence: float = -1.0  # >0 enables early exit at inference
    # >0 enables adaptive width pruning at inference
    width_confidence: float = -1.0
    nll_balancing: float = 0.5
    loss_gamma: float = 1.0
    dtype: str = "float32"


LIGHTGLUE_CONFIGS = {
    "kp2dtiny_S": LightGlueConfig(input_dim=32, descriptor_dim=32,
                                  n_layers=4, num_heads=4),
    "kp2dtiny_A": LightGlueConfig(input_dim=32, descriptor_dim=32,
                                  n_layers=4, num_heads=4),
    "kp2dtiny_F": LightGlueConfig(input_dim=64, descriptor_dim=64,
                                  n_layers=4, num_heads=4),
    "default": LightGlueConfig(),
}

# Training presets mirroring the reference glue-factory YAMLs
# (gluefactory/configs/kp2dtiny*+lightglue_*.yaml: homography pairs from
# a 150k-image set, batch 2, 40 epochs, lr 1e-4, 512/1024 keypoints).
# eval_resize = benchmark preprocessing short-side resize (yaml
# benchmarks.*.data.preprocessing.resize: 120 everywhere except the
# kp2dtiny_S yaml, which evaluates at 480).
GLUEFACTORY_PRESETS = {
    "kp2dtiny+lightglue_homography": dict(
        lg_config="kp2dtiny_S", extractor_config="S", max_keypoints=512,
        batch_size=2, lr=1e-4, n_steps=40 * 75000, eval_resize=120),
    "kp2dtiny_S+lightglue_homography": dict(
        # kp2dtiny_S+lightglue_homography.yaml:55,60: identical to the
        # base preset except the hpatches/megadepth eval resize (120->480)
        lg_config="kp2dtiny_S", extractor_config="S", max_keypoints=512,
        batch_size=2, lr=1e-4, n_steps=40 * 75000, eval_resize=480),
    "kp2dtiny_A+lightglue_homography": dict(
        lg_config="kp2dtiny_A", extractor_config="S_A", max_keypoints=512,
        batch_size=2, lr=1e-4, n_steps=40 * 75000, eval_resize=120),
    "kp2dtiny_F+lightglue_homography": dict(
        lg_config="kp2dtiny_F", extractor_config="F", max_keypoints=512,
        batch_size=2, lr=1e-4, n_steps=40 * 75000, eval_resize=120),
    "kp2dtiny_F+lightglue_megadepth": dict(
        lg_config="kp2dtiny_F", extractor_config="F", max_keypoints=1024,
        batch_size=2, lr=1e-4, n_steps=50 * 75000, eval_resize=120),
}
