"""Flash attention: CUDA kernels (``csrc/flash_fwd_sm90.cu`` for bf16,
``csrc/flash_fwd_tf32_sm90.cu`` for float32, ``csrc/flash_bwd_sm90.cu`` the
bf16 backward), wrapper and plain version."""
