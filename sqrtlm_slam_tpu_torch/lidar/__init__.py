"""LiDAR front end of the fusion path: features, voxel-hash maps, local map."""
