"""The receiver's own demod clock (`Receiver.seconds["demod"]`: dispatch,
the pageable copy in, the wait for the demod, the carry retired) over the
window's pushes, ms a push."""


def read(run):
    before, after = run.counters.get("before", {}), run.counters.get(
        "after", {})
    key = "seconds.demod"
    if key not in before or not run.calls:
        return None
    return (after[key] - before[key]) / len(run.calls) * 1e3
