"""The least work of each hand-written kernel's function, from the
algorithm and its shapes, whoever implements it (one file per kernel),
and the card's peaks (peaks.py). A kernel's roofline share is its least
time over its measured time."""
