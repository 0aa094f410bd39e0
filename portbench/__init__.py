"""Benchmark of the PyTorch/CUDA port (vieo_slam_tpu_torch) on NVIDIA GPUs."""
