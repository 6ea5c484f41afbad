"""Flash attention: CUDA kernel (``csrc/flash_fwd.cu``), wrapper and plain version."""
