"""Synthetic application testbed of the port (``data.applications``)."""
