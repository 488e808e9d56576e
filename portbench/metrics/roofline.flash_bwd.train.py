"""The least time the window's attention backward needs (dQ, dK and dV
of every layer of every step, ``counts.kernels.flash_bwd`` at the card's
published peaks) over the device time of the flash backward kernels,
by name, in the trace."""
from portbench.counts import kernels, peaks


def read(run):
    if run.summary is None or run.device.type != "cuda":
        return None
    took = run.summary.device_time("flash_bwd")
    if took <= 0:
        return None
    cfg, tr = run.cfg, run.traffic
    ops, nbytes = kernels.flash_bwd(
        tr["batch"], tr["seq_len"], cfg["num_attention_heads"],
        cfg["num_key_value_heads"], cfg["head_dim"], cfg.get("sliding_window"))
    need = peaks.least_time(ops, nbytes, peaks.peaks(run.device_name))
    return 100.0 * need * cfg["num_hidden_layers"] * run.record.steps / took
