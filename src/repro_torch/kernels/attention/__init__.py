"""Flash attention: CUDA kernels (``csrc/flash_fwd_sm90.cu`` for bf16,
``csrc/flash_fwd_tf32_sm90.cu`` for float32), wrapper and plain version."""
