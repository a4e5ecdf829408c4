"""Share of the classify calls' engine time the main thread waits on
the output writer: the program's spans ``finish.submit`` (a put on the
writer's full queue) and ``engine.drain`` (the last jobs at the run's
end) over its ``engine.run``, summed over the window's samples (traced
run)."""

from portbench.harness import spans


def read(run):
    return spans.share(run, ["finish.submit", "engine.drain"], "engine.run")
