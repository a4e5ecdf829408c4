"""The output writer thread's busy time as a share of the classify
calls' engine time: the program's spans ``writer.format`` (the ``.all``,
``.one`` and ``.unc`` lines formatted) and ``writer.write`` (the file
writes), recorded on the writer thread, over the main thread's
``engine.run``, summed over the window's samples (traced run)."""

from portbench.harness import spans


def read(run):
    return spans.share(run, ["writer.format", "writer.write"], "engine.run")
