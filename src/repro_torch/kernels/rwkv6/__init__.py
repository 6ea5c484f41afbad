"""RWKV6 WKV chunked scan: tensor-core CUDA kernel (``csrc/rwkv6_fwd_sm90.cu``), wrapper and plain versions."""
