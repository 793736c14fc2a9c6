"""Host ms per round of the sharding layer: the program's mbe.shard.round
span (frame t copied in and replayed on every shard, each on its own
stream, with its copies out enqueued), total ns over count over the whole
run from the program's counters, traced or not. It is the pace one host
thread sets for every card; beside step.busy_ms it says whether the host
or the cards set it. None for a program without the span."""

from portbench.metrics.program_spans import mean_ms


def read(run):
    return mean_ms("mbe.shard.round")
