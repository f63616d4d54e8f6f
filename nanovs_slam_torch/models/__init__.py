"""Counterpart of nanovs_slam_tpu/models."""
