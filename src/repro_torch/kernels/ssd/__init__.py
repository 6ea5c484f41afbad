"""Mamba2 SSD chunked scan: CUDA kernel (``csrc/ssd_fwd_sm90.cu``), wrapper and plain version."""
