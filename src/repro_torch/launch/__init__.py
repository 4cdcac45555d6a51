"""Launch tooling of the port: the step factories (``steps``), meshes
(``mesh``), the specs of params, optimizer state, caches and inputs
(``shardings``), the roofline terms (``hlo_analysis``) and the two
command-line launchers, ``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.serve``.  The reference's cost and memory
models and its dry-run are not ported yet."""
