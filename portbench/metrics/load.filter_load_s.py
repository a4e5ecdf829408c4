"""Seconds of the first load of the cell's filter in set-up, from the
file to the query table on the card: the benchmark's span around
``classify.device.load_device_filter``, synchronized on both ends."""


def read(run):
    return getattr(run.cell, "load_s", None)
