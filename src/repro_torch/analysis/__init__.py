"""Analytic cost models: FLOP and byte closed forms per cell
(:mod:`~repro_torch.analysis.analytic`) and the H100 pricing profile
(:mod:`~repro_torch.analysis.h100`)."""
