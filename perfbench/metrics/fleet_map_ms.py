"""Host ms an iteration in the simulated workers' map step
(``SimulatedCluster.compute`` -> ``make_lm_problem``'s ``grad_fn``), each
call ending in the worker's loss read-back."""


def read(run):
    calls = run.spans.get("fleet.map")
    if not calls or not run.steps:
        return None
    return sum(calls) / len(run.steps)
