"""The benchmark of the PyTorch and CUDA port (hitl_slam_torch): one command
runs one cell once (run.py). See harness.py for how a cell's files are
found."""
