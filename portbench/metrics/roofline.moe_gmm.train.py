"""The least time the window's expert products need, over the device
time of the grouped-product kernels, by name, in the trace. A layer of
a step: the forward's three products (gate and up, d to f; down, f to
d) and the backward's dx and dw of each, over tokens x top_k routed rows
(``counts.kernels.gmm_fwd``, ``gmm_bwd``) at the card's published
peaks; remat's second forward is not counted."""
from portbench.counts import kernels, peaks


def read(run):
    cfg = run.cfg
    if run.summary is None or run.device.type != "cuda" or \
            cfg["ffn"] != "moe":
        return None
    took = run.summary.device_time("gmm_")
    if took <= 0:
        return None
    tr, peak = run.traffic, peaks.peaks(run.device_name)
    E, d, f = cfg["num_local_experts"], cfg["hidden_size"], \
        cfg["intermediate_size"]
    rows = tr["batch"] * tr["seq_len"] * cfg["num_experts_per_tok"]
    need = 0.0
    for a, b in ((d, f), (d, f), (f, d)):
        need += peaks.least_time(*kernels.gmm_fwd(E, rows, a, b), peak)
        need += peaks.least_time(*kernels.gmm_bwd(E, rows, a, b), peak)
    return 100.0 * need * cfg["num_hidden_layers"] * run.record.steps / took
