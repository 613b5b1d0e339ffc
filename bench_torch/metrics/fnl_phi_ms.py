"""The f_NL phi pass (models/pipeline.py ``Zeldovich.phi_pass``: B4's draw
of phi(k) = D/M, its inverse 3-D transform, (phi + f_NL phi^2) / ppd^3 and
the forward transform, synced at its close): the median over the window's
realizations of the seconds in the program's spans ``fnl.phi_pass``, ms
(nothing where the program keeps no such span)."""

from program_spans import median_ms


def read(run):
    return median_ms(run, "fnl.phi_pass")
