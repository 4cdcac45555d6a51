"""Flash decode (K4): ``ops.decode_attention``."""
