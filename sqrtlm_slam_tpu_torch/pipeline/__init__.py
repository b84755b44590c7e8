"""SLAM pipeline: frame building, tracking, local mapping, system facade."""
