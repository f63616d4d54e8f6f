"""Data- and head-parallel execution on ``torch.distributed``, the
counterpart of ``nanovs_slam_tpu/parallel/``: rank groups and their
collectives (``mesh``), bring-up and spawning (``distributed``), the
data-parallel train step (``data_parallel``), the eval fan-out
(``eval_fanout``) and head-parallel LightGlue (``tp``)."""
