"""SneakPeek core of the PyTorch port: the scheduling window's modules.

Each module mirrors its namesake in the JAX package (``repro.core``).
Import the submodules directly; this package file imports nothing, so
a light module such as ``core.utility`` stays cheap to import.
"""
