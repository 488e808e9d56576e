"""Tokens of every training step of the window, over the whole window,
which ends in torch.cuda.synchronize() (host clock)."""


def read(run):
    rec = run.record
    return rec.steps * rec.tokens_per_step / (rec.t_end - rec.t0)
