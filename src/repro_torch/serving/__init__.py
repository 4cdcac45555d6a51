"""Serving plane of the port: ``EdgeServer`` over ``LMExecutor`` and
``ProfiledBackend``, the single-executor path of ``repro.serving``.

Import the submodules directly (``serving.server``, ``serving.runtime``,
``serving.backends``).
"""
