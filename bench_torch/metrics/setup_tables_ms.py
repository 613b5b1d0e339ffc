"""Set-up tables (utils/power.py, ops/modes.py, ops/plt.py): the median
of the harness's synced span around Zeldovich(param), ms."""


def read(run):
    return run.span_median_ms("setup_tables")
