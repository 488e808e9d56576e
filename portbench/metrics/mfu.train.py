"""6 x the weights a token passes through x the window's tokens, plus
attention's forward and backward FLOPs (``counts.model.train_flops``;
nothing remat recomputes), over the window and the card's published
bf16 peak."""
from portbench.counts import model, peaks


def read(run):
    if run.device.type != "cuda":
        return None
    rec, tr = run.record, run.traffic
    flops = rec.steps * model.train_flops(run.cfg, tr["batch"], tr["seq_len"])
    peak = peaks.peaks(run.device_name)["bf16_flops"]
    return 100.0 * flops / ((rec.t_end - rec.t0) * peak)
