"""``kernels_per_step``: device kernels a step launches, from the traced
window (kernels inside it over its steps; copies and fills not counted).
Moves ``samples_per_s``: each launch costs the host its dispatch."""


def read(run):
    if run.timeline is None or not run.steps:
        return None
    return len(run.timeline.kernels()) / run.steps
