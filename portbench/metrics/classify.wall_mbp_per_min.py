"""Bases of every sample classified in the traced window over the
window's wall time (host clock): the rate a user waits on, per layer,
since the host's own speed moves it too far between runs to hold a
bound."""


def read(run):
    if run.cell.kind != "classify" or not run.bases:
        return None
    return run.bases / 1e6 / (run.window_s / 60)
