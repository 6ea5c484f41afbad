"""Step builders of the port: train, eval and serve (counterpart of
``repro.train``)."""

from .steps import make_decode_step, make_eval_step, make_prefill_step, make_train_step

__all__ = ["make_decode_step", "make_eval_step", "make_prefill_step", "make_train_step"]
