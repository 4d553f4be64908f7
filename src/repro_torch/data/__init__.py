"""Synthetic point clouds (numpy) for tests and the chip check."""
from .pointclouds import (clustered_cloud, dataset_by_name,  # noqa: F401
                          kitti_like_cloud, uniform_cloud)
