"""Mamba2 SSD chunked scan: CUDA kernel (``csrc/ssd_fwd.cu``), wrapper and plain version."""
