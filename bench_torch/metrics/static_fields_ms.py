"""Static fields (ops/modes_real.py): the median of the harness's synced
span around the model's pk_eff and plt_coefs, ms."""


def read(run):
    return run.span_median_ms("static_fields")
