"""The benchmark of the PyTorch / CUDA port: `python3 rtbench/run.py --workload <cell> ...`."""
