"""The chunked selection scan of the compiled window pipeline (``core.pipeline``, ``chunk`` > 0)."""
