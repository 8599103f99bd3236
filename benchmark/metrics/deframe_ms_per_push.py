"""The receiver's own deframe clock (`Receiver.seconds["deframe"]`: the
fetch of the packed result, the host UW FSM, the BP batch and the CRC)
over the window's pushes, ms a push."""


def read(run):
    before, after = run.counters.get("before", {}), run.counters.get(
        "after", {})
    key = "seconds.deframe"
    if key not in before or not run.calls:
        return None
    return (after[key] - before[key]) / len(run.calls) * 1e3
