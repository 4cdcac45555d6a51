"""Launch helpers of the port: the step factories (``launch.steps``).

The reference's meshes, shardings, cost and memory models and launchers
are ROADMAP item 13."""
