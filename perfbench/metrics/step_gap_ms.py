"""The device's idle time between one step's last kernel and the next
step's first, a step (mesh engine: the work mask and the metrics'
read-back in ``ElasticMeshSGD.step``, the batch's upload)."""


def read(run):
    gaps = run.trace.step_gaps_s if run.trace else []
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
