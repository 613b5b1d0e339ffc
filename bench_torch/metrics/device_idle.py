"""Share of the window in which the card ran no kernel, copy or memset, %
(nothing where the trace holds no activity of the card)."""


def read(run):
    if not run.device_events() or not run.window[1]:
        return None
    return 100.0 * (1.0 - run.busy_s() / run.window[1])
