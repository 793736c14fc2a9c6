"""Bytes the harness hands to `push` and gets back from it per
channel-frame (streaming): a count from the arrays' shapes."""


def read(run):
    return run.counters.get("host_bytes_per_frame")
