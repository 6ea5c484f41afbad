"""The port's walk-throughs, one per example of the JAX package
(``examples/*.py``), each run as ``python -m repro_torch.examples.<name>``
and each a ``main(argv)`` that runs on the card unless given
``--device cpu``:

  quickstart               train reduced granite for 60 steps, loss falls
  serve_batched            prefill + greedy decode on reduced granite
  fault_tolerant_training  checkpoint, injected failure, restore, resume
  streaming_scheduler      a bursty scenario with failures, then its replay
  telemetry_dashboard      traced replay, metrics, contention attribution
  hyperx_analysis          the paper's Sections 5-7 on H(16, 4), goldens
  fleet_planner            every arch planned on a Blue Gene/Q pod
  partition_analysis       the paper's tables, advisor, replays, scoring
"""
