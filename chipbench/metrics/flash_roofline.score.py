"""flash_roofline.score: the least time of the causal attention calls of the
prompt forwards finished in the traced window, over the device time of the
kernels named below, in %.  One call per attention call of a
forward (the family's ``attention_calls``), at the batch's (rows, length, heads, kv heads, head dim) in the
activation type; its least time is the larger of its bytes over the
memory's rate and its operations over the tensor cores' peak for that type
(``chipbench.flops.flash_work``)."""

from chipbench import flops

KERNELS = ("flash_fwd_sm90_kernel", "flash_fwd_tf32_sm90_kernel")


def read(run):
    seconds = run.trace.seconds_of(KERNELS)
    if run.peaks is None or seconds == 0:
        return None
    cfg, tr = run.cell.cfg, run.cell.traffic
    bf16 = cfg["activation_dtype"] == "bfloat16"
    nbytes, ops = flops.flash_work(tr["rows"], tr["length"], cfg["n_heads"], cfg["n_kv_heads"],
                                   flops.head_dim(cfg), 2 if bf16 else 4)
    rate = run.peaks["bf16_flops" if bf16 else "tf32_flops"]
    calls = run.units * flops.counts(cfg).attention_calls(cfg)
    return 100 * calls * flops.bound_s(nbytes, ops, rate, run.peaks["hbm_bytes_per_s"]) / seconds
