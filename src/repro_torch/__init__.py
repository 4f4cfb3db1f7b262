"""PyTorch/CUDA port of the MMFL system (``repro``), for the NVIDIA H100."""
