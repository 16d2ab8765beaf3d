"""idle_share.serve: the share of the traced batches' wall time in which no
operation ran on the card, in percent: 1 - the card's busy seconds in the
device-only traced pass (torch.profiler) over the seconds the same batches
took untraced in the window.  The profiler's own cost on the host widens
the traced span, so the span is not the base.  (The result line's
``busy_s`` and ``window_s`` are the traced pass's own.)"""


def read(run):
    if (run.entry != "serve" or run.trace is None or run.trace.busy_s <= 0
            or not run.profiled.get("untraced_s")):
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.profiled["untraced_s"])
