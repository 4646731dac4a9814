"""Model step (Model.prefill): wall time of the window's prefill calls,
each ended by torch.cuda.synchronize(), over the real prompt tokens they
served (padding is cost, not tokens), in us a token."""


def read(run):
    calls = run.window_prefills()
    tokens = sum(p[4] for p in calls)
    if not tokens:
        return None
    return 1e6 * sum(p[1] - p[0] for p in calls) / tokens
