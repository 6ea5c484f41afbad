"""The H100 pricing profile: the card's published peaks, which the fleet
planner (:mod:`repro_torch.launch.planner`) reads by name at call time.

NVIDIA H100 SXM 80GB HBM3 at its 700 W limit, dense rates without
sparsity: 989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM and
80 GB of it.  The planner prices a step's compute as the cell's compiled
FLOPs over ``PEAK_FLOPS`` per chip, its memory as the cell's HBM bytes
over ``HBM_BW`` per chip, and filters sharding rules whose bf16 weight
shard exceeds ``HBM_BYTES``.  A card held below 700 W runs slower than
these rates; the planner does not read the card.
"""

#: bf16 FLOP/s of one card on the tensor cores (dense).
PEAK_FLOPS = 989e12

#: HBM bytes per second of one card.
HBM_BW = 3.35e12

#: HBM bytes of one card (the planner's weights-only feasibility filter).
HBM_BYTES = 80e9
