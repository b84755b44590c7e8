"""LiDAR: range-image features, voxel-hash maps, local map, odometry, SE3 backend."""
