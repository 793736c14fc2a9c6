"""Device-busy ms per step in the fsm region (parameter decode and FSM):
parameter decode, the spectral update, the repeat, mute and erasure FSM
and, in AMBE, its state commits; from the traced slice."""

from portbench.metrics.regions import busy_ms


def read(run):
    return busy_ms(run, "fsm")
