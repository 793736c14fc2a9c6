"""The window's peak of allocated device memory, in MiB (device):
torch.cuda.max_memory_allocated after reset_peak_memory_stats at the
window's start, less the harness's own device buffers (its pool and its
record of the checked sample)."""


def read(run):
    return run.counters.get("peak_mem_mib")
