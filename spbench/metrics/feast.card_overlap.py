"""feast.card_overlap: the sum of the cards' factor seconds (each timed on
its own stream) over the wall seconds of the window's factorization
(``pipeline.last_run``), mean over the windows: 1 where the cards take
turns, the number of cards where all factor at once."""

from spbench.readers import mean


def read(run):
    return mean(run.counter_values("feast.card_overlap"))
