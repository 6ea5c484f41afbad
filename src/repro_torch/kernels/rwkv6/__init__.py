"""RWKV6 WKV chunked scan: CUDA kernel (``csrc/rwkv6_fwd.cu``), wrapper and plain version."""
