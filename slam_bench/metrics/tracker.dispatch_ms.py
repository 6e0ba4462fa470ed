"""The host's time in `track_step_batched`, from the call until it
returns with the step enqueued (before the poses are copied), averaged
over the window's steps. What is left of a step is the wait for the device."""


def read(run):
    d = run.records.get("dispatch_s")
    if not d:
        return None
    return 1e3 * sum(d) / len(d)
