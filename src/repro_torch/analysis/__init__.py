"""Cost models: FLOP and byte closed forms per cell
(:mod:`~repro_torch.analysis.analytic`), the H100 pricing profile
(:mod:`~repro_torch.analysis.h100`), the three-term roofline with its
collective trace (:mod:`~repro_torch.analysis.roofline`) and the per-axis
attribution and contention-aware pricing of collectives
(:mod:`~repro_torch.analysis.axis_attribution`)."""
