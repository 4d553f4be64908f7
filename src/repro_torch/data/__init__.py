"""Synthetic point clouds (numpy) and the synthetic token pipeline (the
LM's training batches) for tests, examples and the chip check."""
from .pipeline import batch_specs, make_batch, synthetic_stream  # noqa: F401
from .pointclouds import (clustered_cloud, dataset_by_name,  # noqa: F401
                          kitti_like_cloud, uniform_cloud)
