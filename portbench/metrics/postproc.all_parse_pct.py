"""Share of the samples' time spent parsing the ``.all`` file for EM
reassignment: the program's span ``reassign.parse`` over its
``cmd.classify``, summed over the window's samples (traced run)."""

from portbench.harness import spans


def read(run):
    return spans.share(run, ["reassign.parse"], "cmd.classify")
