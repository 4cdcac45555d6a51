"""Distribution of the port: the reference's logical-axis sharding rules
(``sharding``, ``policies``) over a ``torch.distributed`` ``DeviceMesh``,
and the ZeRO-3 route the trainer takes with them (``fsdp``)."""
