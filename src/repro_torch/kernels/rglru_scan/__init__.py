"""The RG-LRU recurrence of the Griffin recurrent block (``models.rglru``)."""
