"""Share of the classify calls' engine time spent waiting for the
device result's copy to the host: the program's span ``finish.fetch``
(the wait on the copy's event) over its ``engine.run``, summed over the
window's samples (traced run)."""

from portbench.harness import spans


def read(run):
    return spans.share(run, ["finish.fetch"], "engine.run")
