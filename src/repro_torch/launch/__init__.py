"""Launch tooling of the port: the step factories (``steps``, the sharded
serving steps among them), meshes and the fake world (``mesh``), the
specs of params, optimizer state, caches and inputs (``shardings``), the
traced step's census and roofline terms (``hlo_analysis``), the memory
and cost models (``memmodel``, ``costmodel``) and three command-line
tools, ``python -m repro_torch.launch.train``, ``python -m
repro_torch.launch.serve`` and ``python -m repro_torch.launch.dryrun``."""
