"""The full-grid assembly (ops/modes_real.py ``synthesize_full_fast_pair``:
its y-chunks' torch ops, once in the phi pass and once for the output's
arrays, each synced at its open and close): the median over the window's
realizations of the seconds in the program's spans ``full.synth``, ms
(nothing where the program keeps no such span)."""

from program_spans import median_ms


def read(run):
    return median_ms(run, "full.synth")
