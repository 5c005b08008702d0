"""Kernels of the port and their plain PyTorch versions.

Each wrapper (`flood_scan`, `absorb_best_edges`, `table_gather`,
`pgather`) takes its plain version for CPU tensors only; a CUDA tensor
launches the hand-written sm_90a kernel from `csrc/` or raises."""
