"""The distributed layer (port of ``repro.distributed``): the sharding
rules and their DTensor placements (:mod:`.sharding`) and the
collective-matmul rings (:mod:`.collective_matmul`)."""
