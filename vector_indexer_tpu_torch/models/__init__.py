"""Trainers: k-means for the index build."""
