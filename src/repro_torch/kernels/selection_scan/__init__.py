"""The selection scan of the compiled window pipeline (``core.pipeline``)."""
