"""The part of the PLT eigenmode table's read that set-up waits for
(models/pipeline.py ``Zeldovich.__init__``: the table is read and sent to
the device on a worker thread beside P(k) and the pcg64 tables, and
``SynthTables.build`` joins it): the median over the window's
realizations of the seconds in the program's spans ``setup.eig_wait``,
ms (nothing where the program keeps no such span)."""

from program_spans import median_ms


def read(run):
    return median_ms(run, "setup.eig_wait")
