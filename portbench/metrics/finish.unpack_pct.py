"""Share of the classify calls' engine time spent unpacking the fetched
results on the host (the packed layouts, the pruned forest's lane map):
the program's span ``finish.unpack`` over its ``engine.run``, summed over
the window's samples (traced run)."""

from portbench.harness import spans


def read(run):
    return spans.share(run, ["finish.unpack"], "engine.run")
