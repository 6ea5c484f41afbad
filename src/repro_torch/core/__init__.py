"""Machine models of the paper and its Experiment B kernel (counterpart of
``repro.core``): the Blue Gene/Q tables (:mod:`.bgq`) and Strassen-Winograd
with the CAPS communication model (:mod:`.strassen`)."""
