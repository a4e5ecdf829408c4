"""Share of the classify calls' engine time spent uploading read batches
to the card (``put_batch``, from pageable host memory): the program's
span ``dispatch.upload`` over its ``engine.run``, summed over the
window's samples (traced run)."""

from portbench.harness import spans


def read(run):
    return spans.share(run, ["dispatch.upload"], "engine.run")
