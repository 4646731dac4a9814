"""Model step (serving/engine.py -> models/model.py Model.decode): wall
time of the window's decode calls, each ended by torch.cuda.synchronize(),
over their count, in ms."""


def read(run):
    calls = run.window_decodes()
    if not calls:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1, *_ in calls) / len(calls)
