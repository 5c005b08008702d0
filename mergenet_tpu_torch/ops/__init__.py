"""Kernels of the decode and their plain PyTorch versions.

Each wrapper (`flood_scan`, `absorb_best_edges`, `table_gather`) takes
its plain version for CPU tensors only; a CUDA tensor launches the
hand-written sm_90a kernel from `csrc/` or raises."""
