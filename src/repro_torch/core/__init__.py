"""Machine models of the paper (counterpart of ``repro.core``)."""
