"""Machine models of the paper and its Experiment B kernel (counterpart of
``repro.core``): the Blue Gene/Q tables (:mod:`.bgq`), the hypercube, HyperX
and Dragonfly closed forms of the paper's Section 5 (:mod:`.topology`) and
Strassen-Winograd with the CAPS communication model (:mod:`.strassen`)."""
