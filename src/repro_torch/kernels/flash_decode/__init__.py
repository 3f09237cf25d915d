"""Decode attention, paged and ring (ports of the Pallas ``flash_decode_paged``
and ``flash_decode``)."""
