"""Host ms an iteration in the master event loop itself (``MasterEventLoop``,
the scheduler, the allocator, the deadline): an iteration's time, ending
in a synchronisation, less its map and its reduce."""


def read(run):
    if not run.steps or "fleet.map" not in run.spans:
        return None
    rest = sum(run.steps) - sum(run.spans["fleet.map"]) \
        - sum(run.spans.get("fleet.reduce", []))
    return rest / len(run.steps)
